"""The port's sequence evaluators against the JAX package's, on a shared
probe or batch: bitseq's flip-test probe, the uniform probes of TFBind8,
QM9 and AMP (JAX's draws replayed, so the port's probe is JAX's state for
state), the Monte-Carlo log P_theta(x) and its correlations with log R,
the log Z bounds, the sampled TV/JSD with mode hits, and AMP's top-k
reward and diversity.

Noise: sources that replay JAX's draws.  A backward rollout of sample i
of ``log_prob_mc_estimate`` is keyed ``split(key, N)[i]`` in JAX and
``sample_seeds(seed, N)[i]`` in the port; the replay maps one to the
other.

Tolerances: probe states bitwise, their log-rewards 1e-6 relative;
log-probabilities, correlations and bounds 1e-5; histograms and mode
hits to fp32 rounding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.evals import sampling as jsampling  # noqa: E402
from repro.evals.bounds import LogZBoundsEval as JaxBounds  # noqa: E402
from repro.metrics import distributions as jm  # noqa: E402
from repro.recipes.base import RunOptions  # noqa: E402
from repro.recipes.seqs import _bitseq_probe as jax_bitseq_probe  # noqa: E402
from repro_torch.core.types import sample_seeds  # noqa: E402
from repro_torch.evals import (LogZBoundsEval,  # noqa: E402
                               RewardCorrelationEval,
                               SampledDistributionEval, uniform_probe_states)
from repro_torch.metrics import distributions as tm  # noqa: E402
from repro_torch.recipes import seqs as trecipes  # noqa: E402
from test_torch_seqs import (REL, _bitseq_policies, _np,  # noqa: E402
                             _same_state, _seq_policy_pair)

torch.set_num_threads(2)

#: one JAX policy and its port per env, shared by the tests of a module
_pair = functools.lru_cache(maxsize=None)(_seq_policy_pair)


@jax.jit
def _replay_keyed(keys, ids, ts, shape_ta):
    """The categorical draw of env ids[r] at step ts[r] of a rollout keyed
    keys[r] over T steps and A actions (forward and backward rollouts fold
    alike)."""
    T, A = shape_ta.shape

    def one(key, i, t):
        step_key = jax.random.split(key, T)[t]
        _, key_c, _ = jax.random.split(jax.random.fold_in(step_key, i), 3)
        return jax.random.gumbel(key_c, (A,))

    return jax.vmap(one)(keys, ids, ts)


def replay(seeds, keys, T):
    """A noise source replaying JAX's draws: a row of the port's 64-bit
    seed ``seeds[i]`` draws as JAX's rollout keyed ``keys[i]``."""
    lookup = {int(s): i for i, s in enumerate(seeds)}

    def noise(seed, index, t, num_actions):
        rows = jnp.asarray([lookup[s] for s in seed.tolist()])
        return torch.from_numpy(_np(_replay_keyed(
            keys[rows], jnp.asarray(index.numpy(), jnp.int32),
            jnp.asarray(t.numpy(), jnp.int32), jnp.zeros((T, num_actions)))))

    return noise


def _mc_replay(key, seed, n, T):
    return replay(sample_seeds(seed, n), jax.random.split(key, n), T)


def test_bitseq_probe_and_reward_correlation_match_jax():
    """The flip-test probe state for state, then log P_theta by 10 MC
    backward rollouts and its correlations with log R (JAX's per-sample
    keys replayed)."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _bitseq_policies(16, 4)
    jterm, jlog_r = jax_bitseq_probe(jenv, jp, RunOptions(seed=0))
    tterm, tlog_r = trecipes.bitseq_probe(tenv, tp, seed=0)
    _same_state(jterm, tterm, "probe")
    np.testing.assert_allclose(tlog_r.numpy(), _np(jlog_r), rtol=1e-6)
    key, seed = jax.random.PRNGKey(9), -12345
    noise = _mc_replay(key, seed, 10, tenv.max_steps)
    want = jax.jit(lambda k, p: jm.log_prob_mc_estimate(
        k, jenv, jp, jpol.apply, p, jterm, 10))(key, jparams)
    got = tm.log_prob_mc_estimate(seed, tenv, tp, tpol, tterm, 10,
                                  noise=noise)
    np.testing.assert_allclose(got.numpy(), _np(want), **REL)
    # JAX's RewardCorrelationEval is these two metrics of that estimate
    jev = {"pearson": jm.pearson_correlation(want, jlog_r),
           "spearman": jm.spearman_correlation(want, jlog_r)}
    tev = RewardCorrelationEval(tenv, tp, tpol, tterm, tlog_r,
                                mc_samples=10, noise=noise)(seed)
    for m in ("pearson", "spearman"):
        np.testing.assert_allclose(float(tev[m]), float(jev[m]), **REL)


@pytest.mark.parametrize("name", ["tfbind8", "qm9", "amp"])
def test_uniform_probe_and_correlation_match_jax(name):
    """With JAX's draws replayed the port's uniform probe is JAX's, state
    for state (AMP's with the forced stop); the correlation eval over it
    agrees (8 MC samples)."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _pair(name)
    stop = tenv.stop_action if name == "amp" else None
    key = jax.random.PRNGKey(23)
    jterm, jlog_r = jax.jit(lambda k: jsampling.uniform_probe_states(
        k, jenv, jp, 16, stop_action=stop))(key)
    tterm, tlog_r = uniform_probe_states(
        0, tenv, tp, 16, stop_action=stop,
        noise=replay([0], key[None], tenv.max_steps))
    _same_state(jterm, tterm, "probe")
    np.testing.assert_allclose(tlog_r.numpy(), _np(jlog_r), rtol=1e-6)
    key, seed = jax.random.PRNGKey(8), 77
    jev = jax.jit(jsampling.RewardCorrelationEval(
        jenv, jp, jpol.apply, jterm, jlog_r, mc_samples=8))(key, jparams)
    tev = RewardCorrelationEval(
        tenv, tp, tpol, tterm, tlog_r, mc_samples=8,
        noise=_mc_replay(key, seed, 8, tenv.max_steps))(seed)
    for m in ("pearson", "spearman"):
        np.testing.assert_allclose(float(tev[m]), float(jev[m]), **REL)


@pytest.mark.parametrize("name", ["tfbind8", "amp"])
def test_sampled_and_bounds_evals_match_jax(name):
    """The recipes' sampled TV/JSD and mode hits (TFBind8, the target's
    top 128) and log Z bounds, JAX's forward draws replayed: the port's
    fused cached rollout samples JAX's uncached batch."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _pair(name)
    T = tenv.max_steps
    key, seed = jax.random.PRNGKey(5), 3
    k_fwd = jax.random.split(key)[0]
    jev = jax.jit(JaxBounds(jenv, jp, jpol.apply, num_samples=32))(
        key, jparams)
    tev = LogZBoundsEval(tenv, tp, tpol, num_samples=32,
                         noise=replay([seed], k_fwd[None], T))(seed)
    for m in ("elbo", "log_z_is"):
        np.testing.assert_allclose(float(tev[m]), float(jev[m]), **REL)
    if name != "tfbind8":
        return
    true = jax.nn.softmax(jenv.true_log_rewards(jp))
    modes = jnp.argsort(-true)[:128]
    twant = tenv.true_distribution(tp)
    np.testing.assert_allclose(twant.numpy(), _np(true), rtol=1e-5, atol=1e-8)
    tmodes = torch.argsort(-twant, stable=True)[:128]
    np.testing.assert_array_equal(tmodes.numpy(), _np(modes))
    jev = jax.jit(jsampling.SampledDistributionEval(
        jenv, jp, jpol.apply, lambda b: jenv.flatten_index(b.obs[-1]),
        4 ** 8, true_dist=true, mode_indices=modes, num_samples=64))(
        key, jparams)
    tev = SampledDistributionEval(
        tenv, tp, tpol, lambda b: tenv.flatten_index(b.obs[-1]), 4 ** 8,
        true_dist=torch.from_numpy(_np(true)), mode_indices=tmodes,
        num_samples=64, noise=replay([seed], key[None], T))(seed)
    for m in ("sample_tv", "sample_jsd", "mode_hits"):
        np.testing.assert_allclose(float(tev[m]), float(jev[m]), rtol=1e-6,
                                   atol=1e-7)


def test_amp_eval_reads_the_top_samples():
    _, (tenv, tp, tpol) = _pair("amp")
    out = trecipes.amp_eval(tenv, tp, tpol, num_samples=32, k=10)(4)
    assert set(out) == {"top100_reward", "diversity"}
    assert 0 < out["top100_reward"] <= 1 and out["diversity"] >= 0
