"""The port's evals against the JAX package's: the hypergrid exact DP, the
distribution metrics, the backward rollout, the log Z bounds and the
sampled-distribution eval (noise replayed from JAX's draws), the recipe's
tied mode set, and the suite's cadence and noise seeds.

Tolerances: the DP and the metrics 1e-6 absolute (fp32 sums of at most a
few hundred terms in another order), 1e-5 on the 4,096-state target;
log-probabilities and bounds 1e-5 relative; histograms and mode hits
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.rollout import backward_rollout as jax_backward  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.evals.bounds import LogZBoundsEval as JaxBounds  # noqa: E402
from repro.evals.exact import make_hypergrid_dp as jax_dp  # noqa: E402
from repro.evals.sampling import SampledDistributionEval as JaxSampled  # noqa: E402
from repro.metrics import distributions as jax_metrics  # noqa: E402
from repro.recipes.hypergrid import _index_fn as jax_index_fn  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch.algo import TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.rollout import backward_rollout  # noqa: E402
from repro_torch.core.types import eval_seed, train_seed  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.evals import (EvalSuite, LogZBoundsEval,  # noqa: E402
                               SampledDistributionEval, make_exact_dp,
                               make_hypergrid_dp)
from repro_torch.metrics import distributions as metrics  # noqa: E402
from repro_torch.recipes import get_train  # noqa: E402
from repro_torch.recipes.hypergrid import (hypergrid_evals,  # noqa: E402
                                           terminal_index_fn)
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
REL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.array(x)


def _setup(dim, side, hidden=(16, 16), seed=1, learn_backward=False):
    """JAX env, params, policy and policy params; the port's env, params
    and an MLP carrying the same parameters."""
    jenv = JaxHypergrid(JaxReward(), dim=dim, side=side)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=hidden,
                           learn_backward=learn_backward)
    jparams = jpol.init(jax.random.PRNGKey(seed))
    tenv = HypergridEnvironment(HypergridRewardModule(), dim=dim, side=side)
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=hidden, learn_backward=learn_backward,
                     device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jparams), \
        (tenv, tenv.init(CPU), tpol)


@jax.jit
def _replay_gumbel(key, ids, ts, shape_ta):
    """The categorical draw (``key_c``) of a statically-unexploring step:
    env ids[r] at step ts[r] of a rollout keyed ``key`` over T steps."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        _, key_c, _ = jax.random.split(jax.random.fold_in(step_keys[t], i), 3)
        return jax.random.gumbel(key_c, (A,))

    return jax.vmap(one)(ids, ts)


def replay_gumbel(key, T):
    """A noise source replaying the Gumbel draws of a JAX rollout keyed
    ``key`` (forward, or backward: both fold the same way)."""

    def noise(seed, index, t, num_actions):
        return torch.from_numpy(_np(_replay_gumbel(
            key, jnp.asarray(index.numpy(), jnp.int32),
            jnp.asarray(t.numpy(), jnp.int32), jnp.zeros((T, num_actions)))))

    return noise


@pytest.mark.parametrize("dim,side", [(2, 5), (3, 4)])
def test_hypergrid_dp_matches_jax(dim, side):
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(dim, side)
    want = _np(jax_dp(jenv, jp, jpol.apply)(jparams))
    got = make_hypergrid_dp(tenv, tp, tpol)().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got.sum() - 1) < 1e-6
    np.testing.assert_allclose(make_exact_dp(tenv, tp, tpol)().numpy(), got,
                               rtol=0, atol=0)


def test_exact_dp_refuses_bitseq_by_name():
    """The bitseq DP is ported (``make_bitseq_dp``; held against JAX's in
    ``tests/test_torch_seqs.py``): ``make_exact_dp`` no longer refuses
    bitseq, and refuses by name only an env it cannot enumerate."""
    env = BitSeqEnvironment(n=8, k=4)
    policy = MLPPolicy(env.L * (env.m + 1), env.action_dim, hidden=(8,),
                       device=CPU)
    policy.apply = lambda obs: {"logits": torch.zeros(
        obs.shape[0], env.action_dim)}
    dist = make_exact_dp(env, env.init(CPU), policy)()
    assert dist.shape == (env.m ** env.L,)
    # the uniform policy: every word sequence has probability m^-L
    np.testing.assert_allclose(dist.numpy(), 1.0 / env.m ** env.L,
                               rtol=1e-6)
    with pytest.raises(TypeError, match="BitSeq"):
        make_exact_dp(object(), None, policy)


@pytest.mark.parametrize("case", ["plain", "out_of_range", "empty",
                                  "weighted"])
def test_distribution_metrics_match_jax(case):
    rng = np.random.RandomState(5)
    N = 25
    idx = rng.randint(0, N, size=200)
    weights = None
    if case == "out_of_range":
        idx[::7] = N + 3
        idx[1::9] = -2
    elif case == "empty":
        idx = np.full(10, N + 1)
    elif case == "weighted":
        weights = rng.rand(200).astype(np.float32)
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.from_numpy(weights)
    want = _np(jax_metrics.empirical_distribution(
        jnp.asarray(idx, jnp.int32), N, jw))
    got = metrics.empirical_distribution(torch.from_numpy(idx), N, tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    if case == "empty":
        np.testing.assert_array_equal(got.numpy(), np.full(N, 1 / N,
                                                           np.float32))
    target = rng.dirichlet(np.ones(N)).astype(np.float32)
    target[3] = 0.0
    target /= target.sum()
    for name in ("total_variation", "jensen_shannon"):
        w = float(getattr(jax_metrics, name)(jnp.asarray(want),
                                             jnp.asarray(target)))
        g = float(getattr(metrics, name)(got, torch.from_numpy(target)))
        assert abs(g - w) <= 1e-6, name


def _probe(tenv, jenv, n, seed):
    idx = np.random.RandomState(seed).randint(0, tenv.num_terminal_states,
                                              size=n)
    return (jenv.terminal_state_from_flat_index(jnp.asarray(idx, jnp.int32)),
            tenv.terminal_state_from_flat_index(torch.from_numpy(idx)))


@pytest.mark.parametrize("backward_policy,head", [
    ("learned", False), ("uniform", False), ("learned", True),
    ("uniform", True)])
def test_backward_rollout_matches_jax(backward_policy, head):
    """With and without a learned backward head (``logits_b``)."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(
        2, 5, learn_backward=head)
    js, ts = _probe(tenv, jenv, 12, seed=2)
    key = jax.random.PRNGKey(9)
    jb = jax_backward(key, jenv, jp, jpol.apply, jparams, js,
                      backward_policy=backward_policy)
    tb = backward_rollout(0, tenv, tp, tpol, ts,
                          noise=replay_gumbel(key, tenv.max_steps),
                          backward_policy=backward_policy)
    np.testing.assert_allclose(tb.log_pb.numpy(), _np(jb.log_pb), **REL)
    np.testing.assert_allclose(tb.log_pf.numpy(), _np(jb.log_pf), **REL)
    assert tb.batch is None and (tb.log_pb.numpy() <= 0).all()
    with pytest.raises(NotImplementedError, match="collect"):
        backward_rollout(0, tenv, tp, tpol, ts, collect=True)


def test_log_z_bounds_match_jax():
    """ELBO and log_z_is from a forward rollout, EUBO from backward
    rollouts over a probe handed in; JAX's eval key is split into its
    forward and backward keys, whose draws the port replays."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(2, 5)
    js, ts = _probe(tenv, jenv, 24, seed=4)
    key = jax.random.PRNGKey(21)
    want = JaxBounds(jenv, jp, jpol.apply, num_samples=32, target_states=js,
                     target_log_r=jenv.log_reward(js, jp))(key, jparams)
    k_fwd, k_bwd = jax.random.split(key)
    ev = LogZBoundsEval(tenv, tp, tpol, num_samples=32, target_states=ts,
                        target_log_r=tenv.log_reward(ts, tp),
                        noise=replay_gumbel(k_fwd, tenv.max_steps),
                        backward_noise=replay_gumbel(k_bwd, tenv.max_steps))
    got = ev(0)
    assert set(got) == set(ev.metric_names) == {"elbo", "log_z_is", "eubo"}
    for name in ev.metric_names:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   err_msg=name, **REL)


def test_sampled_eval_and_tied_modes_match_jax():
    """The recipe's modes on the 4x8^4 target (4,096 states, exact ties in
    every reward band) are JAX's ``argsort(-true)[:64]``, and the sampled
    TV/JSD and mode hits of a replayed rollout equal JAX's."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(4, 8)
    jtrue = jenv.true_distribution(jp)
    jmodes = jnp.argsort(-jtrue)[:64]
    evals = hypergrid_evals(tenv, tp, tpol, seed=0, eval_batch=48)
    sampled = next(e for e in evals
                   if isinstance(e, SampledDistributionEval))
    np.testing.assert_array_equal(sampled.mode_indices.numpy(), _np(jmodes))
    # ties are real: the 64 modes share one reward value with other states
    true = tenv.true_distribution(tp)
    assert int((true == true[sampled.mode_indices[-1]]).sum()) > 64
    key = jax.random.PRNGKey(6)
    want = JaxSampled(jenv, jp, jpol.apply, jax_index_fn(jenv),
                      tenv.num_terminal_states, true_dist=jtrue,
                      mode_indices=jmodes, num_samples=48)(key, jparams)
    ev = SampledDistributionEval(tenv, tp, tpol, terminal_index_fn(tenv),
                                 tenv.num_terminal_states, true_dist=true,
                                 mode_indices=sampled.mode_indices,
                                 num_samples=48,
                                 noise=replay_gumbel(key, tenv.max_steps))
    got = ev(0)
    assert float(got["mode_hits"]) == float(want["mode_hits"])
    for name in ("sample_tv", "sample_jsd"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)


class _Recorder:
    """An evaluator that records the seeds it is called with."""

    def __init__(self, name):
        self.metric_names = (name,)
        self.seeds = []

    def __call__(self, seed):
        self.seeds.append(seed)
        return {self.metric_names[0]: torch.tensor(float(len(self.seeds)))}


def test_suite_rows_steps_and_seeds():
    a, b = _Recorder("a"), _Recorder("b")
    suite = EvalSuite([a, b], every=2, seed=7)
    for it in range(5):
        suite.maybe_record(it)
    rows = suite.rows()
    assert [r["step"] for r in rows] == [0, 2, 4]      # JAX: num_rows(5)=3
    assert rows[-1] == {"step": 4, "a": 3.0, "b": 3.0}
    assert a.seeds == [eval_seed(7, it, 0) for it in (0, 2, 4)]
    assert b.seeds == [eval_seed(7, it, 1) for it in (0, 2, 4)]
    seeds = a.seeds + b.seeds
    assert len(set(seeds)) == 6 and all(s < 0 for s in seeds)
    assert all(train_seed(7, it) >= 0 for it in range(5))
    with pytest.raises(ValueError, match="duplicate"):
        EvalSuite([a, _Recorder("a")])


def test_evals_leave_training_bitwise_unchanged():
    """Three hypergrid_subtb iterations with the recipe's evals at every
    iteration and without: the same parameters, bit for bit."""
    recipe = get_train("hypergrid_subtb")
    out = []
    for with_evals in (False, True):
        env = recipe.make_env(dim=2, side=4)
        params = env.init(CPU)
        policy = recipe.make_policy(env, seed=0, device=CPU,
                                    requires_grad=True)
        loop = TrainLoop(env, params, policy, recipe.make_config(env, 8, 3))
        suite = EvalSuite(recipe.make_evals(env, params, policy, seed=0,
                                            eval_batch=64),
                          every=1) if with_evals else None
        loop.run(0, 3, suite=suite)
        if with_evals:
            assert [r["step"] for r in suite.rows()] == [0, 1, 2]
        out.append({k: v.detach().clone()
                    for k, v in policy.params.flat().items()})
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
