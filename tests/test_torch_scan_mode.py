"""The port's compiled training modes against the JAX package's, on the
CPU: ``TrainLoop.run(mode="scan")`` against ``repro.algo.TrainLoop.run(key,
n, mode="scan")`` for hypergrid TB, DB and SubTB on a 2x5 grid with an MLP
(16, 16), and for bitseq TB at n=16, k=4 with a 2-layer, dim-32 decode
policy, both from JAX-initialised parameters; ``mode="python"`` against
``mode="scan"``; the device forms of the exploration epsilon and the noise
seed against their host forms; the callback and eval-suite rules.

On the CPU both modes run ``TrainLoop.iteration``, the body a CUDA graph
captures on the card (``tests/test_torch_cuda.py`` replays it there).

Noise: step-noise sources that replay JAX's draws (as
``tests/test_torch_hypergrid_train.py`` and ``tests/test_torch_train.py``
do).  Iteration i of JAX's loop samples with ``k_sample = split(key_i)[1]``;
env e at step t folds ``split(k_sample, T)[t]`` with e and splits the
result into ``(key_u, key_c, key_m)``.

Tolerances (fp32 on both sides, other reduction orders, three iterations):
``loss`` and ``log_z`` 1e-5 relative (``log_z`` with a 1e-7 floor),
``mean_log_reward`` and ``log_rewards`` 1e-6 relative, the tolerances of
``tests/test_torch_hypergrid_train.py``.  Port against port, and device
forms against host forms: bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import current_eps as jax_current_eps  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch import recipes  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy, TransformerPolicy  # noqa: E402
from repro_torch.core.trainer import (GFNConfig, current_eps,  # noqa: E402
                                      current_eps_tensor)
from repro_torch.core.types import (StepNoise, hash_step_noise,  # noqa: E402
                                    train_seed)
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.evals import EvalSuite  # noqa: E402
from repro_torch.recipes.hypergrid import hypergrid_evals  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
ITERS = 3
B = 4
EPS = 0.5            # explore on about half the rows: both branches run
LR, LOG_Z_LR = 1e-3, 1e-1
DIM, SIDE, HIDDEN, ANNEAL = 2, 5, (16, 16), 4
N, K = 16, 4
SMALL = dict(num_layers=2, dim=32, num_heads=4)


def _np(x):
    return np.array(x)          # a writable copy, safe for torch.from_numpy


@jax.jit
def _replay_rows(k_sample, ids, ts, shape_ta):
    """JAX's (gumbel_c, gumbel_u, u_m) for env ids[r] at step ts[r] of a
    rollout keyed ``k_sample`` over T = shape_ta.shape[0] steps and A =
    shape_ta.shape[1] actions."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(k_sample, T)

    def one(i, t):
        env_key = jax.random.fold_in(step_keys[t], i)
        key_u, key_c, key_m = jax.random.split(env_key, 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def _k_samples(key):
    """The rollout key of each iteration of JAX's loop: key_0 =
    split(key)[1]; key_{i+1}, k_sample_i = split(key_i)."""
    out, k = [], jax.random.split(key)[1]
    for _ in range(ITERS):
        k, ks = jax.random.split(k)
        out.append(ks)
    return out


def replay_step_noise(key, T):
    """A step-noise source replaying JAX's draws for the run keyed
    ``key``; the port's 64-bit noise seed names the iteration in its low
    32 bits."""
    k_samples = _k_samples(key)

    def noise(seed, index, t, num_actions):
        g, gu, u = _replay_rows(k_samples[int(seed[0]) & 0xFFFFFFFF],
                                jnp.asarray(index.numpy(), jnp.int32),
                                jnp.asarray(t.numpy(), jnp.int32),
                                jnp.zeros((T, num_actions)))
        return StepNoise(torch.from_numpy(_np(g)), torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))

    return noise


def _hypergrid_pair(objective):
    kw = dict(objective=objective, num_envs=B, lr=LR, log_z_lr=LOG_Z_LR,
              stop_action=DIM, exploration_eps=EPS,
              exploration_anneal_steps=ANNEAL)
    jenv = JaxHypergrid(JaxReward(), dim=DIM, side=SIDE)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=HIDDEN)
    tenv = HypergridEnvironment(HypergridRewardModule(), dim=DIM, side=SIDE)
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=HIDDEN, device=CPU, requires_grad=True)
    return (jenv, jpol, JaxGFNConfig(**kw)), (tenv, tpol, GFNConfig(**kw))


def _bitseq_pair(objective):
    kw = dict(objective=objective, num_envs=B, lr=LR, exploration_eps=EPS)
    jenv = JaxBitSeq(n=N, k=K)
    jpol = make_transformer_policy(jenv.vocab_size, jenv.L, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **SMALL)
    tenv = BitSeqEnvironment(n=N, k=K)
    tpol = TransformerPolicy(tenv.vocab_size, tenv.L, tenv.action_dim,
                             device=CPU, requires_grad=True, **SMALL)
    return (jenv, jpol, JaxGFNConfig(**kw)), (tenv, tpol, GFNConfig(**kw))


@pytest.mark.parametrize("make,objective", [
    (_hypergrid_pair, "tb"), (_hypergrid_pair, "db"),
    (_hypergrid_pair, "subtb"), (_bitseq_pair, "tb")])
def test_scan_mode_matches_jax_scan_mode(make, objective):
    (jenv, jpol, jcfg), (tenv, tpol, cfg) = make(objective)
    key = jax.random.PRNGKey(3)
    _, (jm, jlog_r) = JaxTrainLoop(
        jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jcfg).run(
        key, ITERS, mode="scan")
    # JAX's loop draws its initial parameters from split(key)[0]
    tpol.load_params(params_from_jax(jax.device_get(
        jpol.init(jax.random.split(key)[0]))))
    loop = TrainLoop(tenv, tenv.init(CPU), tpol, cfg, sampler=OnPolicySampler(
        noise=replay_step_noise(key, tenv.max_steps)))
    state, (metrics, log_r) = loop.run(0, ITERS, mode="scan")
    assert state.step == ITERS
    assert set(metrics) == set(jm)
    assert log_r.shape == jlog_r.shape == (ITERS, B)
    for k in metrics:
        assert metrics[k].shape == jm[k].shape == (ITERS,)
    np.testing.assert_allclose(metrics["loss"].numpy(), _np(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["log_z"].numpy(), _np(jm["log_z"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(metrics["mean_log_reward"].numpy(),
                               _np(jm["mean_log_reward"]), rtol=1e-6)
    np.testing.assert_allclose(log_r.numpy(), _np(jlog_r), rtol=1e-6)


def _recipe_loop(name, env_kw, seed=1):
    rec = recipes.get_train(name)
    env = rec.make_env(**env_kw)
    pol = rec.make_policy(env, seed=seed, device=CPU, requires_grad=True)
    cfg = rec.make_config(env, B, 8)
    return TrainLoop(env, env.init(CPU), pol, cfg), rec, env


@pytest.mark.parametrize("name,env_kw", [
    ("hypergrid_tb", {"dim": 2, "side": 4}),
    ("hypergrid_db", {"dim": 2, "side": 4}),
    ("hypergrid_subtb", {"dim": 2, "side": 4}),
    ("bitseq_tb", {"n": 8, "k": 2}),
    ("amp_tb", {"max_len": 10})])
def test_python_mode_equals_scan_mode(name, env_kw):
    """Step for step, bitwise: the python mode's callback rows against the
    scan mode's stacked outputs, and the parameters after the run."""
    loop_p, _, _ = _recipe_loop(name, env_kw)
    loop_s, _, _ = _recipe_loop(name, env_kw)
    rows = []
    loop_p.run(5, ITERS, callback=lambda it, st, m, b: rows.append(
        ({k: v.clone() for k, v in m.items()}, b.log_reward.clone())))
    _, (metrics, log_r) = loop_s.run(5, ITERS, mode="scan")
    assert len(rows) == ITERS
    for it, (m, lr) in enumerate(rows):
        for k, v in m.items():
            assert torch.equal(metrics[k][it], v), (k, it)
        assert torch.equal(log_r[it], lr), it
    for (n, a), (_, b) in zip(loop_p.policy.params.flat().items(),
                              loop_s.policy.params.flat().items()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("eps,anneal", [
    (0.3, 10), (0.1, 7), (0.05, 0), (1e-3, 0), (0.7, 1), (0.1, 10000),
    (1.0, 50000)])
def test_device_eps_is_bitwise_the_host_eps(eps, anneal):
    """Over steps 0 .. anneal + 2 (the last three past the anneal): the
    device epsilon's float32 bits are the host's; the recipes' schedules
    (hypergrid 0.1 over 10,000, TFBind8 / QM9 1.0 over 50,000) included.
    JAX's traced ``current_eps`` gives the same values."""
    cfg = GFNConfig(exploration_eps=eps, exploration_anneal_steps=anneal)
    steps = np.arange(anneal + 3)
    host = np.array([current_eps(cfg, int(s)) for s in steps], np.float32)
    dev = current_eps_tensor(cfg, torch.from_numpy(steps))
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy().view(np.int32),
                                  host.view(np.int32))
    one = current_eps_tensor(cfg, torch.tensor(anneal // 2))
    assert one.shape == () and one.numpy().view(np.int32) == \
        host[anneal // 2].view(np.int32)
    jcfg = JaxGFNConfig(exploration_eps=eps, exploration_anneal_steps=anneal)
    check = steps[:: max(1, len(steps) // 64)]
    jax_eps = np.array([float(jax_current_eps(jcfg, jnp.int32(s)))
                        for s in check], np.float32)
    np.testing.assert_array_equal(jax_eps, host[check])


@pytest.mark.parametrize("mode", ["python", "scan"])
def test_device_seed_counter_is_train_seed(mode):
    """Every iteration's rollout draws from the device seed
    ``train_seed(seed, i)``, bitwise, over steps 0 .. anneal + 2; the
    counter ends at the iteration count."""
    seen = []

    def spy(seed, index, t, num_actions):
        if int(t[0]) == 0:
            seen.append(int(seed[0]))
        return hash_step_noise(seed, index, t, num_actions)

    env = HypergridEnvironment(HypergridRewardModule(), dim=2, side=3)
    pol = MLPPolicy(env.obs_dim, env.action_dim, hidden=(8,), device=CPU,
                    requires_grad=True)
    cfg = GFNConfig(objective="tb", num_envs=2, stop_action=env.dim,
                    exploration_eps=0.5, exploration_anneal_steps=ANNEAL)
    loop = TrainLoop(env, env.init(CPU), pol, cfg,
                     sampler=OnPolicySampler(noise=spy))
    seed, n = 2 ** 31 - 1, ANNEAL + 3
    state, _ = loop.run(seed, n, mode=mode)
    assert seen == [train_seed(seed, i) for i in range(n)]
    assert state.counter.dtype == torch.int64 and int(state.counter) == n
    assert int(state.noise_seed()) == train_seed(seed, n)
    with pytest.raises(ValueError, match="out of range"):
        loop.init(2 ** 31)


def test_scan_mode_refuses_a_callback():
    loop, _, _ = _recipe_loop("hypergrid_tb", {"dim": 2, "side": 3})
    with pytest.raises(ValueError, match="callback"):
        loop.run(0, 2, mode="scan", callback=lambda *a: None)
    with pytest.raises(ValueError, match="unknown mode"):
        loop.run(0, 2, mode="pmap")


def test_eval_suite_rows_equal_under_both_modes():
    """The recipe's hypergrid evals every 2 iterations: the same rows, at
    the same iterations, whichever mode drives the loop."""
    rows = {}
    for mode in ("python", "scan"):
        loop, _, env = _recipe_loop("hypergrid_subtb", {"dim": 2, "side": 4})
        suite = EvalSuite(hypergrid_evals(env, loop.env_params, loop.policy,
                                          seed=0, eval_batch=64),
                          every=2, seed=0)
        loop.run(0, 5, mode=mode, suite=suite)
        rows[mode] = suite.rows()
    assert [r["step"] for r in rows["python"]] == [0, 2, 4]
    assert rows["python"] == rows["scan"]
