"""The port's samplers against the JAX package's (``repro.algo.samplers``):
each of the four samplers' batches over three iterations, with the
carried replay buffer, on a 2x4 hypergrid with an MLP (16, 16) that has a
learned backward head (so ``backward_replay`` draws from a learned P_B),
from JAX-initialised parameters carried across; the registry and
``make_sampler``.  The sequence env (tfbind8), the training loop and the
CLI are in ``tests/test_torch_samplers_loop.py``.

Noise: sources that replay JAX's draws.  Iteration i of a sampler is
keyed ``k_i``; an on-policy sampler rolls out on ``k_i`` itself, a replay
sampler splits it into ``(k_roll, k_sel, k_replay)``: the fresh rollout
(env e at step t folds ``split(k_roll, T)[t]`` with e and splits the
result into ``(key_u, key_c, key_m)``), the selection (the indices
``randint(k_sel, (R,), 0, size)`` drew, as uniforms, or the Gumbel rows
``gumbel(k_sel, (R, capacity))`` of its ``categorical``) and the backward
rollout (``key_c`` of the fold of ``split(k_replay, T)[t]`` with row r).

Tolerances (fp32 on both sides): actions, masks, observations and the
buffer's states bitwise; log-rewards 1e-6 relative; log P_F 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import samplers as jsamplers  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch.algo import samplers as tsamplers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise, train_seed  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIM, SIDE = 2, 4
HIDDEN = (16, 16)
B, R, CAP = 4, 3, 6            # the buffer wraps in the second iteration
ITERS = 3
CFG = dict(objective="tb", num_envs=B, exploration_eps=0.3,
           exploration_anneal_steps=4)
BATCH_EXACT = ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
               "valid", "done")


def _np(x):
    return np.array(x)


# -- noise sources replaying JAX's draws ---------------------------------------

@jax.jit
def _step_rows(key, ids, ts, shape_ta):
    """(gumbel_c, gumbel_u, u_m) of env ids[r] at step ts[r] of a rollout
    keyed ``key`` over T = shape_ta.shape[0] steps, A actions."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        key_u, key_c, key_m = jax.random.split(
            jax.random.fold_in(step_keys[t], i), 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def _iteration(seed):
    return int(seed[0]) & 0xFFFFFFFF


def replay_step_noise(key_of, T):
    """Step noise of the rollout keyed ``key_of(iteration)``."""
    def noise(seed, index, t, num_actions):
        g, gu, u = _step_rows(key_of(_iteration(seed)),
                              jnp.asarray(index.numpy(), jnp.int32),
                              jnp.asarray(t.numpy(), jnp.int32),
                              jnp.zeros((T, num_actions)))
        return StepNoise(torch.from_numpy(_np(g)), torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))
    return noise


def replay_backward_gumbel(key_of, T):
    """The backward rollout's Gumbels (``key_c``) under ``key_of(i)``."""
    def noise(seed, index, t, num_actions):
        g, _, _ = _step_rows(key_of(_iteration(seed)),
                             jnp.asarray(index.numpy(), jnp.int32),
                             jnp.asarray(t.numpy(), jnp.int32),
                             jnp.zeros((T, num_actions)))
        return torch.from_numpy(_np(g))
    return noise


def replay_select_noise(key_of, size_of):
    """The selection's draws under ``key_of(i)``: the slots JAX's
    ``randint`` drew over the ``size_of(i)`` filled slots, as uniforms, or
    the Gumbel rows of its ``categorical``."""
    def noise(seed, index, capacity, prioritized):
        i = _iteration(seed)
        n = len(index)
        if prioritized:
            return torch.from_numpy(_np(jax.random.gumbel(
                key_of(i), (n, capacity))))
        size = max(size_of(i), 1)
        idx = _np(jax.random.randint(key_of(i), (n,), 0, size))
        return torch.from_numpy(((idx + 0.5) / size).astype(np.float32))
    return noise


def replay_sources(key_of, T, batch=B):
    """The three sources of a replay sampler whose iteration i is keyed
    ``key_of(i)``."""
    def part(j):
        return lambda i: jax.random.split(key_of(i), 3)[j]
    return dict(noise=replay_step_noise(part(0), T),
                select_noise=replay_select_noise(
                    part(1), lambda i: min((i + 1) * batch, CAP)),
                backward_noise=replay_backward_gumbel(part(2), T))


# -- running both --------------------------------------------------------------

def run_pair(jsampler, tsampler, jenv, jp, jpol, jparams, tenv, tp, tpol,
             jcfg, cfg):
    """ITERS iterations of both samplers from fresh states at fixed
    parameters: per iteration the JAX batch and buffer, the port's."""
    init_j, sample_j = jsampler.build(jenv, jp, jpol, jcfg)
    sample_j = jax.jit(sample_j)
    init_t, sample_t = tsampler.build(tenv, tp, tpol, cfg)
    js, ts = init_j(), init_t()
    rows = []
    for i in range(ITERS):
        js, jb = sample_j(js, KEY_OF(i), jparams, jnp.int32(i))
        ts, tb = sample_t(ts, torch.tensor(train_seed(0, i)),
                          torch.tensor(i))
        tbuf = None if ts is None else (
            {k: v.clone() for k, v in ts.data.items()},
            int(ts.insert_pos), int(ts.size))
        rows.append((jax.tree_util.tree_map(_np, jb),
                     jax.tree_util.tree_map(_np, js), tb, tbuf))
    return rows


def KEY_OF(i):
    return jax.random.fold_in(jax.random.PRNGKey(11), i)


def assert_batch_matches(tb, jb, what):
    for name in BATCH_EXACT:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      getattr(jb, name),
                                      err_msg=f"{what} {name}")
    np.testing.assert_allclose(tb.log_reward.numpy(), jb.log_reward,
                               rtol=1e-6, atol=1e-6, err_msg=what)
    np.testing.assert_allclose(tb.log_pf_beh.numpy(), jb.log_pf_beh,
                               rtol=1e-5, atol=1e-5, err_msg=what)
    for name in ("log_r_state", "energy"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   getattr(jb, name), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what} {name}")


def assert_buffer_matches(tbuf, jstate, what):
    data, pos, size = tbuf
    assert pos == int(jstate.insert_pos) and size == int(jstate.size), what
    jdata = jstate.data
    for f in dataclasses.fields(jdata["state"]):
        np.testing.assert_array_equal(data[f.name].numpy(),
                                      getattr(jdata["state"], f.name),
                                      err_msg=f"{what} state.{f.name}")
    np.testing.assert_allclose(data["log_reward"].numpy(),
                               jdata["log_reward"], rtol=1e-6, atol=1e-6,
                               err_msg=f"{what} log_reward")


# -- the hypergrid ---------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    jenv = JaxHypergrid(JaxReward(), dim=DIM, side=SIDE)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=HIDDEN,
                           learn_backward=True)
    jparams = jpol.init(jax.random.PRNGKey(5))
    tenv = HypergridEnvironment(HypergridRewardModule(), dim=DIM, side=SIDE)
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim,
                     tenv.backward_action_dim, hidden=HIDDEN,
                     learn_backward=True, device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jparams,
            tenv, tenv.init(CPU), tpol)


GRID_CASES = {
    "on_policy": dict(),
    "eps_noisy": dict(eps=0.5, anneal_steps=4),
    "replay": dict(capacity=CAP, replay_batch=R),
    "replay_prioritized": dict(capacity=CAP, replay_batch=R,
                               prioritized=True, temperature=0.7),
    "backward_replay": dict(capacity=CAP, replay_batch=R, prioritized=True),
}


def _samplers(case, T):
    name = case.replace("_prioritized", "")
    kw = GRID_CASES[case]
    if name in ("replay", "backward_replay"):
        sources = replay_sources(KEY_OF, T)
    else:
        sources = dict(noise=replay_step_noise(KEY_OF, T))
    return (jsamplers.make_sampler(name, **kw),
            tsamplers.make_sampler(name, **kw, **sources))


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_batches_match_jax(grid, case):
    jenv, jp, jpol, jparams, tenv, tp, tpol = grid
    jcfg = JaxGFNConfig(stop_action=DIM, **CFG)
    cfg = GFNConfig(stop_action=DIM, **CFG)
    js, ts = _samplers(case, tenv.max_steps)
    rows = run_pair(js, ts, jenv, jp, jpol, jparams, tenv, tp, tpol, jcfg,
                    cfg)
    replay = "replay" in case
    for i, (jb, jstate, tb, tbuf) in enumerate(rows):
        want_rows = B + R if replay else B
        assert tb.actions.shape[1] == want_rows == ts.batch_size(cfg)
        assert_batch_matches(tb, jb, f"{case} it {i}")
        if replay:
            assert_buffer_matches(tbuf, jstate, f"{case} it {i}")
            # the replayed rows were rebuilt with no log P_F pass
            assert not tb.log_pf_beh[:, B:].any()
        else:
            assert tbuf is None and jstate == ()
    if case == "eps_noisy":
        # the sampler's own schedule, not the config's: eps 0.5 at it 0
        assert ts._eps(cfg, torch.tensor(0)).item() == np.float32(0.5)
        assert ts._eps(cfg, torch.tensor(2)).item() == np.float32(0.25)


def test_backward_replay_reads_the_learned_head(grid):
    """backward_replay's replayed rows follow the learned P_B (the MLP's
    logits_b), replay's the uniform one: on the same draws they differ."""
    jenv, jp, jpol, jparams, tenv, tp, tpol = grid
    cfg = GFNConfig(stop_action=DIM, **CFG)
    out = {}
    for name in ("replay", "backward_replay"):
        s = tsamplers.make_sampler(name, capacity=CAP, replay_batch=R,
                                   **replay_sources(KEY_OF, tenv.max_steps))
        init, sample = s.build(tenv, tp, tpol, cfg)
        st = init()
        for i in range(ITERS):
            st, batch = sample(st, torch.tensor(train_seed(0, i)),
                               torch.tensor(i))
        out[name] = batch.bwd_actions[:, B:]
    assert not torch.equal(out["replay"], out["backward_replay"])


def test_registry_matches_jax():
    assert sorted(tsamplers.SAMPLERS) == sorted(jsamplers.SAMPLERS)
    for name, cls in tsamplers.SAMPLERS.items():
        assert cls.name == name
        s = tsamplers.make_sampler(name)
        assert isinstance(s, cls)
        assert tsamplers.make_sampler(s) is s
        if hasattr(cls, "backward_policy"):
            assert cls.backward_policy == \
                jsamplers.SAMPLERS[name].backward_policy
    with pytest.raises(KeyError, match="unknown sampler"):
        tsamplers.make_sampler("nope")
    # JAX's defaults
    for name in ("replay", "backward_replay"):
        j, t = jsamplers.make_sampler(name), tsamplers.make_sampler(name)
        assert (t.capacity, t.replay_batch, t.prioritized, t.temperature) \
            == (j.capacity, j.replay_batch, j.prioritized, j.temperature)
