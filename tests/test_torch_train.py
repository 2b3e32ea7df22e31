"""The port's bitseq_tb training slice against the JAX package's, at bitseq
n=16, k=4 with a 2-layer, dim-32, 4-head decode policy whose JAX-initialised
parameters are carried across.

Its parts (bitseq's backward steps, one exploring rollout,
``evaluate_trajectory`` and the TB parts, the optimizer and the epsilon
schedule) are held in ``tests/test_torch_train_parts.py``, on this file's
fixture and helpers.

Noise: a step-noise source that replays JAX's draws.  Iteration i of
``repro.algo.TrainLoop`` samples with ``k_sample = split(key_i)[1]``
(``repro/algo/loop.py:131``); env i at step t folds
``split(k_sample, T)[t]`` with i and splits the result into
``(key_u, key_c, key_m)`` (``repro/core/types.py:141-154``).  The replay
source hands the port exactly those Gumbel and uniform draws.

Tolerances (fp32 on both sides, different reduction orders): actions and
tokens bitwise; log-probs and losses 1e-5 relative; gradients 1e-4
relative, with an absolute floor of 1e-6 times the largest entry of the
same tensor (an entry is a sum over B * T steps of terms as large as
that, so its rounding error scales with it, not with the entry).
Parameters after an Adam step: at step 1
Adam's update is -lr * g / (|g| + 1e-8), so where |g| <= 1e-6 the two
packages' gradients may round to different signs and the parameters
differ by up to 2 * lr; there the test allows 2 * lr per step taken.
Every other entry is held to 1e-3 * lr per step taken: an update is lr
times a ratio of gradient moments, and that ratio carries the gradients'
relative rounding (1e-5 at worst) and the log Z group's lr is 0.1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.core.rollout import RolloutBatch  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K = 16, 4
SMALL = dict(num_layers=2, dim=32, num_heads=4)
B = 4
EPS = 0.5            # explore on about half the rows: both branches run
LR, LOG_Z_LR = 1e-3, 1e-1
ITERS = 3
REL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _np(x):
    return np.array(x)          # a writable copy, safe for torch.from_numpy


@jax.jit
def _replay_rows(k_sample, ids, ts, shape_a):
    """JAX's (gumbel_c, gumbel_u, u_m) for env ids[r] at step ts[r] of a
    rollout keyed ``k_sample`` with T = 4 steps (bitseq n=16, k=4)."""
    step_keys = jax.random.split(k_sample, N // K)

    def one(i, t):
        env_key = jax.random.fold_in(step_keys[t], i)
        key_u, key_c, key_m = jax.random.split(env_key, 3)
        A = shape_a.shape[0]
        return (jax.random.gumbel(key_c, (A,)), jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def replay_noise(k_sample_of):
    """A step-noise source replaying JAX's draws; ``k_sample_of(seed)``
    names the rollout key of the 64-bit noise seed the port passes."""

    def noise(seed, index, t, num_actions):
        g, gu, u = _replay_rows(k_sample_of(int(seed[0])),
                                jnp.asarray(index.numpy(), jnp.int32),
                                jnp.asarray(t.numpy(), jnp.int32),
                                jnp.zeros((num_actions,)))
        return StepNoise(torch.from_numpy(_np(g)), torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))

    return noise


@pytest.fixture(scope="module")
def pair():
    """JAX env/policy/params and the port's, same (JAX-initialised)
    parameters; the port's require grad."""
    jenv = JaxBitSeq(n=N, k=K)
    jpol = make_transformer_policy(jenv.vocab_size, jenv.L, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **SMALL)
    key = jax.random.PRNGKey(3)
    jparams = jpol.init(jax.random.split(key)[0])
    tenv = BitSeqEnvironment(n=N, k=K)
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jparams, key), \
        (tenv, tenv.init(CPU))


def _torch_policy(jparams):
    tenv = BitSeqEnvironment(n=N, k=K)
    tpol = TransformerPolicy(tenv.vocab_size, tenv.L, tenv.action_dim,
                             device=CPU, requires_grad=True, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return tpol


def _jax_batch_to_torch(jb) -> RolloutBatch:
    f = lambda x: torch.from_numpy(_np(x))
    return RolloutBatch(
        obs=f(jb.obs), fwd_mask=f(jb.fwd_mask), bwd_mask=f(jb.bwd_mask),
        actions=f(jb.actions).long(), bwd_actions=f(jb.bwd_actions).long(),
        valid=f(jb.valid), done=f(jb.done), log_reward=f(jb.log_reward),
        log_r_state=f(jb.log_r_state), energy=f(jb.energy),
        log_pf_beh=f(jb.log_pf_beh))


def _assert_batches_equal(tb: RolloutBatch, jb):
    for name in ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
                 "valid", "done", "log_r_state", "energy"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      _np(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(tb.log_reward.numpy(), _np(jb.log_reward),
                               **REL)
    np.testing.assert_allclose(tb.log_pf_beh.numpy(), _np(jb.log_pf_beh),
                               **REL)


@pytest.fixture(scope="module")
def three_iterations(pair):
    """Three iterations of both loops from the same parameters and noise:
    per iteration the batch, the metrics and the parameters after the
    update; and the step-1 gradients."""
    (jenv, jp, jpol, jparams0, key), (tenv, tp) = pair
    jcfg = JaxGFNConfig(objective="tb", num_envs=B, lr=LR,
                        exploration_eps=EPS)
    jrows = []

    def cb(it, ts, metrics, batch):
        jrows.append({"params": jax.tree_util.tree_map(_np, ts.params),
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "batch": jax.tree_util.tree_map(_np, batch)})

    JaxTrainLoop(jenv, jp, jpol, jcfg).run(key, ITERS, mode="python",
                                          callback=cb, callback_every=1)
    (jnum, jden), jgrads = jax.value_and_grad(
        jax_parts_fn(jenv, jpol, jcfg), has_aux=True)(
        jparams0, jax.tree_util.tree_map(jnp.asarray, jrows[0]["batch"]))
    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda g: _np(g / jnp.maximum(jden, 1.0)), jgrads))

    # the loop's key chain: key_0 = split(key)[1]; key_{i+1}, k_sample_i =
    # split(key_i)
    k_samples, k = [], jax.random.split(key)[1]
    for _ in range(ITERS):
        k, ks = jax.random.split(k)
        k_samples.append(ks)
    tpol = _torch_policy(jparams0)
    cfg = GFNConfig(objective="tb", num_envs=B, lr=LR, exploration_eps=EPS)
    loop = TrainLoop(tenv, tp, tpol, cfg, sampler=OnPolicySampler(
        noise=replay_noise(lambda s: k_samples[s & 0xFFFFFFFF])))
    state = loop.init(seed=0)
    trows = []
    for it in range(ITERS):
        batch = loop.sample(state)
        loss = loop.loss_and_grads(batch)
        grads = {n: p.grad.clone() for n, p in tpol.params.flat().items()}
        state.optimizer.step()
        state.step += 1
        trows.append({"batch": batch, "loss": float(loss), "grads": grads,
                      "params": {n: p.detach().clone() for n, p in
                                 tpol.params.flat().items()},
                      "log_z": float(tpol.params["log_z"].detach()),
                      "mean_log_reward": float(batch.log_reward.mean())})
    return jrows, trows, jgrads


def test_train_loop_batches_and_losses_match_jax(three_iterations):
    jrows, trows, _ = three_iterations
    for it, (jr, tr) in enumerate(zip(jrows, trows)):
        _assert_batches_equal(tr["batch"], jr["batch"])
        np.testing.assert_allclose(tr["loss"], jr["metrics"]["loss"],
                                   rtol=1e-5, err_msg=f"iteration {it}")
        np.testing.assert_allclose(tr["mean_log_reward"],
                                   jr["metrics"]["mean_log_reward"],
                                   rtol=1e-6)
        np.testing.assert_allclose(tr["log_z"], jr["metrics"]["log_z"],
                                   rtol=1e-5)


def test_step1_gradients_match_jax(three_iterations):
    _, trows, jgrads = three_iterations
    tgrads = trows[0]["grads"]
    assert set(tgrads) == set(jgrads)
    for name, g in jgrads.items():
        g = g.numpy()
        np.testing.assert_allclose(tgrads[name].numpy(), g, err_msg=name,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max())


def test_parameters_follow_the_adam_rule(three_iterations):
    jrows, trows, jgrads = three_iterations
    for it, (jr, tr) in enumerate(zip(jrows, trows)):
        jflat = params_from_jax(jr["params"])
        for name, p in tr["params"].items():
            lr = LOG_Z_LR if name == "log_z" else LR
            want = jflat[name].numpy()
            got = p.numpy()
            big = np.abs(jgrads[name].numpy()) > 1e-6
            np.testing.assert_allclose(got[big], want[big], rtol=0,
                                       atol=1e-3 * lr * (it + 1),
                                       err_msg=f"{name} it {it}")
            assert np.all(np.abs(got - want)[~big]
                          <= 2 * lr * (it + 1) + 1e-7), (name, it)


def test_cli_trains_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "bitseq_tb", "--iterations", "2",
                           "--device", "cpu", "--set", f"n={N}",
                           "--set", f"k={K}", "--num-envs", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("it ")]
    assert len(rows) == 2
    for ln in rows:
        vals = ln.split()
        assert vals[2] == "loss" and np.isfinite(float(vals[3]))
        assert vals[4] == "log_z" and vals[6] == "mean_log_reward"
    assert "on cpu" in out[-1]


def test_cli_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "bitseq_tb", "--iterations", "1"])
