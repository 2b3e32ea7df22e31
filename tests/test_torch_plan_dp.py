"""The port's ``data_parallel`` over 2 gloo ranks against JAX's
``DataParallelPlan`` over as many of the conftest's virtual devices (4
ranks: ``tests/test_torch_plan_dp4.py``; the CLI's plan flags:
``tests/test_torch_plan_cli.py``).

Each rank is a process of its own (``tests/torch_plan_worker.py``, which
imports no JAX), given its settings as arguments and meeting the others on
a ``FileStore`` in ``tmp_path``.  The cases are hypergrid TB on a 2x4 grid
with an MLP (16, 16) from JAX's initial parameters, on-policy and with the
replay sampler (a per-shard buffer of capacity / D slots), over JAX's
draws replayed: the fresh rollouts' by global env id, the replay's
selection and backward rollout by shard (JAX folds the shard index into
their keys).

Tolerances: JAX's (``tests/test_plan.py:35-51``): losses and log Z rtol
2e-3, atol 1e-4; mean log-rewards rtol 1e-5, atol 1e-6.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import ReplaySampler as JaxReplaySampler  # noqa: E402
from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.algo.plan import DataParallelPlan as JaxDataParallelPlan  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_plan_worker.py"
LOSS_TOL = dict(rtol=2e-3, atol=1e-4)
REWARD_TOL = dict(rtol=1e-5, atol=1e-6)
DIM, SIDE, B, ITERS, HIDDEN, EPS = 2, 4, 8, 4, (16, 16), 0.3
CAP, REPLAY = 32, 8
KEY = jax.random.PRNGKey(5)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4,
    reason="needs 4 (virtual) devices; conftest forces 8 unless XLA_FLAGS "
           "was preset")


def _np(x):
    return np.array(x)


@jax.jit
def _rows(key, ids, ts, shape_ta):
    """JAX's (gumbel_c, gumbel_u, u_m) for env ids[r] at step ts[r] of a
    rollout keyed ``key`` over T = shape_ta.shape[0] steps, A actions."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        key_u, key_c, key_m = jax.random.split(
            jax.random.fold_in(step_keys[t], i), 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def _table(key, n_rows, T, A):
    """(T, n_rows, A) / (T, n_rows) draws of rows 0..n_rows-1."""
    ids = jnp.tile(jnp.arange(n_rows), T)
    ts = jnp.repeat(jnp.arange(T), n_rows)
    g, gu, u = _rows(key, ids, ts, jnp.zeros((T, A)))
    return (_np(g).reshape(T, n_rows, A), _np(gu).reshape(T, n_rows, A),
            _np(u).reshape(T, n_rows))


def _case(D, replay, path):
    """JAX's run of the case over D devices and the file its port ranks
    read: settings, JAX's initial parameters and every draw."""
    jenv = JaxHypergrid(JaxReward(), dim=DIM, side=SIDE)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=HIDDEN)
    cfg = JaxGFNConfig(objective="tb", num_envs=B, stop_action=DIM,
                       exploration_eps=EPS)
    sampler = (JaxReplaySampler(capacity=CAP, replay_batch=REPLAY)
               if replay else None)
    loop = JaxTrainLoop(jenv, jenv.init(jax.random.PRNGKey(0)), jpol, cfg,
                        sampler=sampler,
                        plan=JaxDataParallelPlan(num_devices=D))
    _, (jm, _) = loop.run(KEY, ITERS, mode="scan")
    T, A, Ab = jenv.max_steps, jenv.action_dim, jenv.backward_action_dim
    k_init, k = jax.random.split(KEY)
    case = {"dim": DIM, "side": SIDE, "num_envs": B, "iterations": ITERS,
            "hidden": np.asarray(HIDDEN), "eps": EPS}
    for name, v in params_from_jax(jax.device_get(jpol.init(k_init))).items():
        case["param:" + name.replace("/", "|")] = v.numpy()
    g = np.zeros((ITERS, T, B, A), np.float32)
    gu, u = np.zeros_like(g), np.zeros((ITERS, T, B), np.float32)
    R = REPLAY // D
    sel = np.zeros((D, ITERS, R), np.float32)
    gb = np.zeros((D, ITERS, T, R, Ab), np.float32)
    for i in range(ITERS):
        k, k_sample = jax.random.split(k)
        if not replay:
            g[i], gu[i], u[i] = _table(k_sample, B, T, A)
            continue
        k_roll, k_sel, k_replay = jax.random.split(k_sample, 3)
        g[i], gu[i], u[i] = _table(k_roll, B, T, A)
        size = min((i + 1) * B // D, CAP // D)
        for r in range(D):
            idx = _np(jax.random.randint(jax.random.fold_in(k_sel, r), (R,),
                                         0, size))
            sel[r, i] = (idx + 0.5) / size
            gb[r, i] = _table(jax.random.fold_in(k_replay, r), R, T, Ab)[0]
    case.update(g=g, gu=gu, u=u)
    if replay:
        case.update(cap=CAP, replay=REPLAY, sel=sel, gb=gb)
    np.savez(path, **case)
    return {k: _np(v) for k, v in jm.items()}


def _ranks(D, case, tmp_path):
    """Run the D port ranks of ``case``; rank 0's metrics."""
    out = tmp_path / f"out{D}.npz"
    store = str(tmp_path / f"store{D}")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(D), store, str(case),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(D)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return dict(np.load(out))


def held_against_jax(D, replay, tmp_path):
    """The port's D ranks against JAX's D devices on one case."""
    case = tmp_path / "case.npz"
    jm = _case(D, replay, case)
    tm = _ranks(D, case, tmp_path)
    for k in ("loss", "log_z", "mean_log_reward"):
        assert tm[k].shape == jm[k].shape == (ITERS,)
    np.testing.assert_allclose(tm["loss"], jm["loss"], **LOSS_TOL)
    np.testing.assert_allclose(tm["log_z"], jm["log_z"], **LOSS_TOL)
    np.testing.assert_allclose(tm["mean_log_reward"], jm["mean_log_reward"],
                               **REWARD_TOL)
    if replay:
        # one buffer per shard, each holding its own rollouts' terminals
        assert tm["size"].tolist() == [min(ITERS * B // D, CAP // D)] * D


@pytest.mark.parametrize("replay", [False, True])
def test_data_parallel_matches_jax_data_parallel(replay, tmp_path):
    held_against_jax(2, replay, tmp_path)
