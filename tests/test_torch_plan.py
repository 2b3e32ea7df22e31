"""The port's execution plans (``repro_torch.algo.plan``) against the JAX
package's, case for case with ``tests/test_plan.py`` where the port has
the feature, on the CPU in this process: the registry and ``describe()``,
``auto``'s fallback, ``split_batch``'s errors, the per-shard buffer's
checks, a sampler without ``shard`` refused, rollouts keyed on
``env_offset``, the seed plan's metric shapes, ``seeds_x_data`` against
``vmap_seeds``, resumes under a plan and a restore under another plan,
``run_recipe`` and ``main`` with the plan flags, ``ising_ebgfn`` refusing
a plan; and the kernel wrappers' batching rules against S separate calls.
``vmap_seeds`` is held per seed against single runs (bitwise on the CPU)
and against JAX's ``VmapSeedsPlan`` with JAX's per-seed draws replayed.

A data-parallel loop in this process is a group of one (gloo over a
``FileStore``); the groups of 2 and 4 ranks are in
``tests/test_torch_plan_dp.py`` and ``_dp4.py``, the CLI's ranks in
``tests/test_torch_plan_cli.py`` and ``_resume.py``.

Tolerances: JAX's plan tolerances (``tests/test_plan.py:35-51``): losses
rtol 2e-3, atol 1e-4; mean log-rewards rtol 1e-5, atol 1e-6.  Port
against port: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.algo.plan import VmapSeedsPlan as JaxVmapSeedsPlan  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward_rollout  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch import recipes  # noqa: E402
from repro_torch.algo import (OnPolicySampler, ReplaySampler,  # noqa: E402
                              TrainLoop)
from repro_torch.algo.plan import (DataParallelPlan, ExecutionPlan,  # noqa: E402
                                   PLANS, SeedsByDataPlan, ShardInfo,
                                   VmapSeedsPlan, auto_plan, make_plan,
                                   seed_of)
from repro_torch.buffer.fifo import FIFOBuffer  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402
from repro_torch.run import main, run_recipe  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=2e-3, atol=1e-4)
REWARD_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.array(x)


def _grid(dim=2, side=4):
    env = HypergridEnvironment(HypergridRewardModule(), dim=dim, side=side)
    return env, env.init(CPU)


def _mlp(env, hidden=(8,), seed=0):
    return MLPPolicy(env.obs_dim, env.action_dim, env.backward_action_dim,
                     hidden=hidden, seed=seed, device=CPU,
                     requires_grad=True)


def _cfg(env, num_envs=16, **kw):
    return GFNConfig(objective="tb", num_envs=num_envs, stop_action=env.dim,
                     **kw)


def _recipe_loop(name, plan=None, seed=1, num_envs=4, env_kw=None,
                 **kwargs):
    rec = recipes.get_train(name)
    env = rec.make_env(**(env_kw or {"dim": 2, "side": 4}))
    pol = rec.make_policy(env, seed=seed, device=CPU, requires_grad=True)
    cfg = rec.make_config(env, num_envs, 8)
    return TrainLoop(env, env.init(CPU), pol, cfg, plan=plan,
                     seed_params=lambda sd: rec.make_policy(
                         env, seed=sd, device=CPU).params.flat(), **kwargs)


# -- the registry ------------------------------------------------------------------

class TestPlans:
    def test_make_plan_names_and_describe(self):
        assert sorted(PLANS) == ["data_parallel", "seeds_x_data", "single",
                                 "vmap_seeds"]
        assert type(make_plan("single")) is ExecutionPlan
        assert type(make_plan(None)) is ExecutionPlan
        p = make_plan("data_parallel", devices=4)
        assert isinstance(p, DataParallelPlan)
        assert p.describe() == {"plan": "data_parallel", "device_count": 4,
                                "mesh_shape": [4]}
        assert make_plan("single").describe() == {
            "plan": "single", "device_count": 1, "mesh_shape": None}
        s = make_plan("vmap_seeds", num_seeds=3)
        assert s.seeds == 3 and s.device_count == 1
        sd = make_plan("seeds_x_data", num_seeds=3, devices=2)
        assert sd.seeds == 3 and sd.device_count == 2
        assert isinstance(sd, SeedsByDataPlan)
        inst = DataParallelPlan(num_devices=2)
        assert make_plan(inst) is inst
        assert repr(sd) == "SeedsByDataPlan(device_count=2, " \
                           "mesh_shape=[2], num_seeds=3)"
        with pytest.raises(KeyError):
            make_plan("pmap")
        with pytest.raises(ValueError):
            make_plan("vmap_seeds")

    def test_auto_plan_divisibility_fallback(self):
        # with no card the visible count is 1: pass JAX's 8 explicitly
        assert auto_plan(16, devices=8).name == "data_parallel"
        assert auto_plan(6, devices=8).name == "single"
        assert auto_plan(16, devices=1).name == "single"
        assert auto_plan(16).name == "single"
        assert make_plan("auto", devices=8, num_envs=6).name == "single"
        assert make_plan("auto", devices=8,
                         num_envs=16).name == "data_parallel"
        with pytest.raises(ValueError, match="never adds a seed axis"):
            make_plan("auto", num_seeds=2)

    def test_trainloop_auto_plan_falls_back_on_awkward_batch(self):
        env, ep = _grid()
        pol = _mlp(env)
        loop = TrainLoop(env, ep, pol, _cfg(env, 12),
                         plan=make_plan("auto", devices=8, num_envs=12))
        assert loop.plan.name == "single"
        assert TrainLoop(env, ep, pol, _cfg(env, 16),
                         plan="auto").plan.name == "single"

    def test_non_shard_aware_sampler_rejected_on_mesh(self):
        class Legacy:
            name = "legacy"

            def batch_size(self, cfg):
                return cfg.num_envs

            def build(self, env, env_params, policy, cfg):
                return (lambda: None), (lambda s, k, t: (s, None))

        env, ep = _grid()
        pol = _mlp(env)
        with pytest.raises(TypeError, match="shard"):
            TrainLoop(env, ep, pol, _cfg(env), sampler=Legacy(),
                      plan=DataParallelPlan(4))
        # ...but it still composes with the single-device plan
        TrainLoop(env, ep, pol, _cfg(env), sampler=Legacy(), plan="single")

    def test_shard_info_split_batch_errors(self):
        si = ShardInfo(axis="batch", num_shards=8, rank=3)
        assert si.split_batch(16) == 2
        with pytest.raises(ValueError, match="divisible"):
            si.split_batch(12)
        assert ShardInfo().split_batch(12) == 12
        assert ShardInfo().env_offset(4) == 0
        assert si.env_offset(2) == 6
        seed = torch.tensor((5 << 32) | 9)
        assert torch.equal(ShardInfo().fold_shard(seed), seed)
        assert torch.equal(
            ShardInfo(axis="batch", num_shards=1).fold_shard(seed), seed)
        folded = [ShardInfo("batch", 4, r).fold_shard(seed) for r in
                  range(4)]
        assert len({int(f) for f in folded} | {int(seed)}) == 5
        assert all(int(f) & 0xFFFFFFFF == 9 for f in folded)

    def test_indivisible_batch_raises_at_loop_construction(self):
        env, ep = _grid()
        with pytest.raises(ValueError, match="divisible"):
            TrainLoop(env, ep, _mlp(env), _cfg(env, 12),
                      plan=DataParallelPlan(8))

    def test_seed_of_is_the_single_run_seed(self):
        assert [seed_of(7, s) for s in range(3)] == [7, 8, 9]
        with pytest.raises(ValueError):
            seed_of(2 ** 31 - 1, 1)


# -- per-shard buffers ---------------------------------------------------------------

class TestPerShardFIFO:
    def test_per_shard_capacity_validation(self):
        with pytest.raises(ValueError, match="not divisible"):
            FIFOBuffer.per_shard(100, 8)
        with pytest.raises(ValueError, match="absorb"):
            FIFOBuffer.per_shard(16, 8, min_batch=4)
        assert FIFOBuffer.per_shard(64, 8, min_batch=4).capacity == 8
        assert FIFOBuffer.per_shard(64, 1).capacity == 64

    def test_replay_sampler_rejects_indivisible_capacity(self):
        env, ep = _grid()
        with pytest.raises(ValueError, match="divisible"):
            TrainLoop(env, ep, _mlp(env), _cfg(env),
                      sampler=ReplaySampler(capacity=100),
                      plan=DataParallelPlan(8))

    def test_shards_stay_disjoint(self):
        """Each shard's buffer holds only its own rollouts' terminals: the
        rows of the global batch its env offset names (the port's shards
        are separate samplers, run here one after another)."""
        env, ep = _grid()
        pol = _mlp(env)
        cfg = _cfg(env, 8, exploration_eps=0.2)
        D, it = 4, 3
        full = [forward_rollout(torch.tensor(s), env, ep, pol, 8,
                                exploration_eps=0.2,
                                return_final_state=True) for s in range(it)]
        for r in range(D):
            init, sample = ReplaySampler(capacity=16).build(
                env, ep, pol, cfg, shard=ShardInfo("batch", D, r))
            buf = init()
            for s in range(it):
                buf, batch = sample(buf, torch.tensor(s), torch.tensor(s))
            assert int(buf.size) == 4 == buf.data["pos"].shape[0]
            want = torch.cat([f.pos[2 * r:2 * r + 2]
                              for _, f in full[1:]])
            assert torch.equal(buf.data["pos"][[2, 3, 0, 1]], want)
            assert batch.log_reward.shape == (4,)


# -- rollouts keyed on the global env id --------------------------------------------

@jax.jit
def _jax_step_rows(key, ids, ts, shape_ta):
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        key_u, key_c, key_m = jax.random.split(
            jax.random.fold_in(step_keys[t], i), 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def _replayed(key, T):
    def noise(seed, index, t, num_actions):
        g, gu, u = _jax_step_rows(key, jnp.asarray(index.numpy()),
                                  jnp.asarray(t.numpy()),
                                  jnp.zeros((T, num_actions)))
        return StepNoise(torch.from_numpy(_np(g)),
                         torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))
    return noise


class TestRolloutParity:
    def test_env_offset_rollout_equals_jax_env_offset(self):
        """JAX's ``forward_rollout(b, env_offset=o)`` and the port's on
        JAX's draws: the same actions, done flags and log-rewards."""
        jenv = JaxHypergrid(JaxReward(), dim=2, side=6)
        jparams = jenv.init(jax.random.PRNGKey(0))
        jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                               jenv.backward_action_dim, hidden=(32,))
        pp = jpol.init(jax.random.PRNGKey(0))
        env, ep = _grid(2, 6)
        pol = _mlp(env, (32,))
        pol.load_params(params_from_jax(jax.device_get(pp)))
        k = jax.random.PRNGKey(42)
        for off in (0, 6):
            jb = jax_forward_rollout(k, jenv, jparams, jpol.apply, pp, 4,
                                     exploration_eps=0.1, env_offset=off)
            tb = forward_rollout(0, env, ep, pol, 4, exploration_eps=0.1,
                                 env_offset=off,
                                 noise=_replayed(k, env.max_steps))
            assert np.array_equal(_np(jb.actions), tb.actions.numpy())
            assert np.array_equal(_np(jb.done), tb.done.numpy())
            np.testing.assert_allclose(tb.log_reward.numpy(),
                                       _np(jb.log_reward), rtol=1e-6)

    def test_env_offset_slices_the_same_stream(self):
        """``forward_rollout(b, env_offset=o)`` equals rows [o, o+b) of the
        full-batch rollout, on every branch it takes here (the uncached
        exploring and non-exploring ones); shard r of D draws the rows
        its ``ShardInfo`` gives it (``split_batch`` rows from
        ``env_offset``), field for field: time-major fields along axis 1,
        ``log_reward`` along axis 0."""
        env, ep = _grid(2, 5)
        pol = _mlp(env, (16,))
        for eps in (None, 0.3):
            full = forward_rollout(3, env, ep, pol, 12, exploration_eps=eps)
            part = forward_rollout(3, env, ep, pol, 4, env_offset=5,
                                   exploration_eps=eps)
            assert torch.equal(full.actions[:, 5:9], part.actions)
            assert torch.equal(full.log_reward[5:9], part.log_reward)
            for r in range(3):
                info = ShardInfo("batch", 3, r)
                b = info.split_batch(12)
                o = info.env_offset(b)
                shard = forward_rollout(3, env, ep, pol, b, env_offset=o,
                                        exploration_eps=eps)
                for f in dataclasses.fields(full):
                    x = getattr(full, f.name)
                    axis = 0 if f.name == "log_reward" else 1
                    assert torch.equal(x.narrow(axis, o, b),
                                       getattr(shard, f.name)), f.name


# -- seed plans ----------------------------------------------------------------------

class TestSeedPlans:
    def test_vmap_seeds_plan_scan_shapes(self):
        env, ep = _grid()
        loop = TrainLoop(env, ep, _mlp(env, (16,)), _cfg(env, 8),
                         plan=VmapSeedsPlan(3),
                         seed_params=lambda sd: _mlp(env, (16,),
                                                     sd).params.flat())
        st, (m, log_r) = loop.run(5, 10, mode="scan")
        assert m["loss"].shape == m["log_z"].shape == (10, 3)
        assert log_r.shape == (10, 3, 8)
        assert st.params["log_z"].shape == (3,)
        # seeds are independent runs
        assert not torch.allclose(m["loss"][:, 0], m["loss"][:, 1])

    @pytest.mark.parametrize("name,env_kw", [
        ("hypergrid_tb", {"dim": 2, "side": 4}),
        ("hypergrid_subtb", {"dim": 2, "side": 4}),
        ("bitseq_tb", {"n": 8, "k": 2})])
    def test_each_seed_is_its_single_run(self, name, env_kw):
        """Seed s of a vmap_seeds run seeded 5 is the single run seeded
        ``seed_of(5, s)``: every metric, log-reward and trained leaf,
        bitwise on the CPU."""
        S, n = 3, 4
        vm = _recipe_loop(name, VmapSeedsPlan(S), env_kw=env_kw)
        st, (m, log_r) = vm.run(5, n, mode="scan")
        trained = vm.trained(st)
        for s in range(S):
            one = _recipe_loop(name, seed=seed_of(5, s), env_kw=env_kw)
            st1, (m1, log_r1) = one.run(seed_of(5, s), n, mode="scan")
            for k in m:
                assert torch.equal(m[k][:, s], m1[k]), (s, k)
            assert torch.equal(log_r[:, s], log_r1)
            for k, v in one.trained(st1).items():
                assert torch.equal(trained[k][s], v), (s, k)

    def test_seeds_x_data_plan_runs_and_matches_vmap_seeds(self):
        """The composed plan over a group of one reproduces the pure
        vmap_seeds plan bitwise (2 and 4 ranks:
        ``tests/test_torch_plan_dp.py``)."""
        a = _recipe_loop("hypergrid_tb", VmapSeedsPlan(2), num_envs=8)
        b = _recipe_loop("hypergrid_tb", SeedsByDataPlan(2, num_devices=1),
                         num_envs=8)
        try:
            _, (ma, _) = a.run(5, 6, mode="scan")
            _, (mb, _) = b.run(5, 6, mode="scan")
        finally:
            b.plan.close()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k

    def test_legacy_vmap_seeds_mode_requires_single_plan(self):
        loop = _recipe_loop("hypergrid_tb", DataParallelPlan(1))
        try:
            with pytest.raises(ValueError, match="seeds_x_data"):
                loop.run(0, 5, mode="vmap_seeds", num_seeds=2)
        finally:
            loop.plan.close()
        single = _recipe_loop("hypergrid_tb")
        with pytest.raises(ValueError, match="num_seeds"):
            single.run(0, 5, mode="vmap_seeds")
        _, m = single.run(0, 3, mode="vmap_seeds", num_seeds=2)
        assert m["loss"].shape == (2, 3)

    def test_clip_takes_each_seeds_own_norm(self):
        """With ``max_grad_norm`` each seed is clipped by its own global
        norm: the seed plan still equals its single runs bitwise."""
        def loop(plan, seed=1):
            l = _recipe_loop("hypergrid_tb", plan, seed=seed)
            l.cfg = l.cfg._replace(max_grad_norm=0.5, weight_decay=1e-3)
            return l
        vm = loop(VmapSeedsPlan(2))
        _, (m, _) = vm.run(1, 4, mode="scan")
        for s in range(2):
            _, (m1, _) = loop(None, seed_of(1, s)).run(seed_of(1, s), 4,
                                                       mode="scan")
            assert torch.equal(m["loss"][:, s], m1["loss"])


def _jax_seed_tables(key, S, n, B, T, A):
    """JAX's step draws of every seed of ``VmapSeedsPlan(S)`` keyed
    ``key``: seed s's key is ``split(key, S)[s]``, its iteration i samples
    on ``k_sample_i`` (``key_0 = split(k_s)[1]``, ``key_{i+1}, k_sample_i
    = split(key_i)``).  Returns the (S, n, T, B, A) Gumbel tables and the
    (S, n, T, B) explore uniforms, and each seed's init key."""
    g = np.zeros((S, n, T, B, A), np.float32)
    gu = np.zeros_like(g)
    u = np.zeros((S, n, T, B), np.float32)
    ids = jnp.tile(jnp.arange(B), T)
    ts = jnp.repeat(jnp.arange(T), B)
    inits = []
    for s, ks in enumerate(jax.random.split(key, S)):
        k_init, k = jax.random.split(ks)
        inits.append(k_init)
        for i in range(n):
            k, k_sample = jax.random.split(k)
            a, b, c = _jax_step_rows(k_sample, ids, ts, jnp.zeros((T, A)))
            g[s, i] = _np(a).reshape(T, B, A)
            gu[s, i] = _np(b).reshape(T, B, A)
            u[s, i] = _np(c).reshape(T, B)
    return torch.from_numpy(g), torch.from_numpy(gu), torch.from_numpy(u), \
        inits


def table_noise(g, gu, u, base: int):
    """A step-noise source that looks JAX's draws up by tensor indexing
    alone, so it runs under ``torch.func.vmap``: seed s and iteration i
    from the noise seed ``train_seed(base + s, i)``."""
    def noise(seed, index, t, num_actions):
        s = (seed >> 32) - base
        i = seed & 0xFFFFFFFF
        return StepNoise(g[s, i, t, index], gu[s, i, t, index],
                         u[s, i, t, index])
    return noise


def test_vmap_seeds_matches_jax_vmap_seeds_plan():
    """The port's vmap_seeds(3) against JAX's VmapSeedsPlan(3) on a 2x5
    grid with an MLP (16, 16), from JAX's per-seed initial parameters and
    on JAX's per-seed draws: per-iteration losses, log Z and mean
    log-rewards of every seed, at JAX's plan tolerances."""
    S, n, B, dim, side = 3, 4, 4, 2, 5
    kw = dict(objective="tb", num_envs=B, lr=1e-3, log_z_lr=1e-1,
              stop_action=dim, exploration_eps=0.5)
    jenv = JaxHypergrid(JaxReward(), dim=dim, side=side)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=(16, 16))
    key = jax.random.PRNGKey(3)
    _, (jm, _) = JaxTrainLoop(jenv, jenv.init(jax.random.PRNGKey(0)), jpol,
                              JaxGFNConfig(**kw),
                              plan=JaxVmapSeedsPlan(S)).run(key, n,
                                                            mode="scan")
    env, ep = _grid(dim, side)
    g, gu, u, inits = _jax_seed_tables(key, S, n, B, env.max_steps,
                                       env.action_dim)
    base = 11
    loop = TrainLoop(
        env, ep, _mlp(env, (16, 16)), GFNConfig(**kw),
        sampler=OnPolicySampler(noise=table_noise(g, gu, u, base)),
        plan=VmapSeedsPlan(S),
        seed_params=lambda sd: params_from_jax(jax.device_get(
            jpol.init(inits[sd - base]))))
    _, (m, _) = loop.run(base, n, mode="scan")
    for k in m:
        assert m[k].shape == jm[k].shape == (n, S)
    np.testing.assert_allclose(m["loss"].numpy(), _np(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(m["log_z"].numpy(), _np(jm["log_z"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(m["mean_log_reward"].numpy(),
                               _np(jm["mean_log_reward"]), **REWARD_TOL)


# -- checkpoints ---------------------------------------------------------------------

class TestCheckpointedTrainLoop:
    @pytest.mark.parametrize("plan", ["single", "data_parallel",
                                      "vmap_seeds"])
    def test_resume_reproduces_straight_run(self, plan, tmp_path):
        def loop():
            p = {"single": None, "data_parallel": DataParallelPlan(1),
                 "vmap_seeds": VmapSeedsPlan(2)}[plan]
            return _recipe_loop("hypergrid_tb", p, sampler="replay")
        a = loop()
        straight, _ = a.run(9, 10)
        want = {k: v.clone() for k, v in a.trained(straight).items()}
        a.plan.close()
        mgr = CheckpointManager(tmp_path / "ckpt")
        b = loop()
        try:
            b.run(9, 5, checkpoint=mgr, checkpoint_every=5)
            assert mgr.latest_step() == 5
            resumed, _ = b.run(9, 10, checkpoint=mgr, checkpoint_every=5,
                               restore=True)
        finally:
            b.plan.close()
        assert resumed.step == 10
        for k, v in b.trained(resumed).items():
            assert torch.equal(v, want[k]), k

    def test_restore_under_different_plan_fails_loudly(self, tmp_path):
        """A checkpoint saved under data_parallel carries per-shard sampler
        axes (JAX's layout); restoring it into a single-plan loop
        raises."""
        mgr = CheckpointManager(tmp_path / "ckpt")
        dp = _recipe_loop("hypergrid_tb", DataParallelPlan(1),
                          sampler=ReplaySampler(capacity=64,
                                                replay_batch=16))
        try:
            dp.run(9, 4, checkpoint=mgr, checkpoint_every=4)
        finally:
            dp.plan.close()
        assert mgr.load(4, ".sampler")[".sampler/.size"].shape == (1,)
        single = _recipe_loop("hypergrid_tb",
                              sampler=ReplaySampler(capacity=64,
                                                    replay_batch=16))
        with pytest.raises(ValueError, match="same plan"):
            single.run(9, 8, checkpoint=mgr, restore=True)

    def test_checkpoint_rejected_in_scan_mode(self, tmp_path):
        loop = _recipe_loop("hypergrid_tb", VmapSeedsPlan(2))
        with pytest.raises(ValueError, match="python"):
            loop.run(0, 5, mode="scan",
                     checkpoint=CheckpointManager(tmp_path / "c"))


# -- run_recipe and the CLI ----------------------------------------------------------

class TestRunRecipePlans:
    def test_run_recipe_data_parallel_matches_single(self):
        kw = dict(iterations=6, num_envs=16, eval_every=3, device="cpu",
                  env={"dim": 2, "side": 4}, log=lambda *_: None)
        out1 = run_recipe("hypergrid_tb", plan="single", **kw)
        out8 = run_recipe("hypergrid_tb", plan="data_parallel", devices=1,
                          **kw)
        out8["loop"].plan.close()
        assert [r["loss"] for r in out1["history"]] == \
            [r["loss"] for r in out8["history"]]
        assert out1["rows"] == out8["rows"]

    def test_run_recipe_vmap_seeds_plan(self):
        lines = []
        out = run_recipe("hypergrid_tb", iterations=5, num_envs=8,
                         eval_every=5, env={"dim": 2, "side": 4},
                         plan="vmap_seeds", num_seeds=2, device="cpu",
                         metrics_json="unused.json", log=lines.append)
        assert np.isfinite(out["history"][-1]["loss"])
        assert out["rows"] == [] and out["suite"] is None
        assert lines[0] == ("plan: vmap_seeds over 1 device(s), "
                            "mesh_shape=None, num_seeds=2")
        assert any("--metrics-json is ignored" in ln for ln in lines)

    def test_cli_plan_flag(self, capsys):
        assert main(["--recipe", "hypergrid_tb", "--iterations", "3",
                     "--eval-every", "0", "--num-envs", "8",
                     "--set", "dim=2", "--set", "side=4",
                     "--plan", "vmap_seeds", "--num-seeds", "2",
                     "--device", "cpu"]) == 0
        assert "trained hypergrid_tb for 3 iterations" in \
            capsys.readouterr().out

    def test_run_override_recipe_rejects_plan(self):
        with pytest.raises(ValueError, match="custom training driver"):
            run_recipe("ising_ebgfn", plan="data_parallel", devices=1,
                       device="cpu", log=lambda *_: None)


# -- the batching rules --------------------------------------------------------------

def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("in_dim", [0, 1])
def test_traj_logprob_rule_is_s_separate_calls(in_dim):
    """vmap of ``traj_logprob`` (forward, and its gradient through the
    backward's rule) over S = 3, seed axis at ``in_dim`` of the logits
    and actions, the mask shared (no seed axis): S separate calls',
    bitwise, with one call of each wrapper's plain version."""
    S, B, T, A = 3, 4, 5, 6
    rng = np.random.default_rng(in_dim)
    logits = _rand((S, B, T, A), 1)
    actions = torch.from_numpy(rng.integers(0, A, (S, B, T)))
    mask = torch.from_numpy(rng.random((B, T, A)) < 0.8)
    mask[..., 0] = True
    actions = torch.where(mask.expand(S, B, T, A).gather(
        -1, actions[..., None])[..., 0], actions, 0)
    valid = torch.from_numpy(rng.random((S, B, T)) < 0.9)
    w = _rand((S, B), 2)

    def total(lg, ac, v, ww):
        tot, step = ops.traj_logprob(lg, ac, mask, v)
        return (tot * ww).sum() + step.sum()

    move = (lambda x: x.movedim(0, 1)) if in_dim else (lambda x: x)
    calls = [ops.ref_traj_logprob, ops.ref_traj_logprob_backward]
    counted = []
    fwd, bwd = ops.ref_traj_logprob, ops.ref_traj_logprob_backward
    try:
        ops.ref_traj_logprob = lambda *a: counted.append("f") or fwd(*a)
        ops.ref_traj_logprob_backward = \
            lambda *a: counted.append("b") or bwd(*a)
        grads = torch.func.vmap(torch.func.grad(total),
                                in_dims=(in_dim, in_dim, 0, 0))(
            move(logits), move(actions), valid, w)
        tots = torch.func.vmap(
            lambda lg: ops.traj_logprob(lg, actions[0], mask, valid[0])[0],
            in_dims=in_dim)(move(logits))
    finally:
        ops.ref_traj_logprob, ops.ref_traj_logprob_backward = calls
    assert counted == ["f", "b", "f"]
    for s in range(S):
        lg = logits[s].clone().requires_grad_()
        total(lg, actions[s], valid[s], w[s]).backward()
        assert torch.equal(grads[s], lg.grad)
        assert torch.equal(tots[s], ops.traj_logprob(
            logits[s], actions[0], mask, valid[0])[0])


@pytest.mark.parametrize("in_dim", [0, 1])
def test_subtb_loss_rule_is_s_separate_calls(in_dim):
    S, B, T1 = 3, 5, 7
    phi = _rand((S, B, T1), 3)
    length = torch.tensor([0, 6, 3, 1, 5])
    f = lambda p: (ops.subtb_loss(p, length, 0.8) ** 2).sum()  # noqa: E731
    move = (lambda x: x.movedim(0, 1)) if in_dim else (lambda x: x)
    grads = torch.func.vmap(torch.func.grad(f), in_dims=in_dim)(move(phi))
    losses = torch.func.vmap(lambda p: ops.subtb_loss(p, length, 0.8),
                             in_dims=in_dim)(move(phi))
    for s in range(S):
        p = phi[s].clone().requires_grad_()
        f(p).backward()
        assert torch.equal(grads[s], p.grad)
        assert torch.equal(losses[s], ops.subtb_loss(phi[s], length, 0.8))
    with pytest.raises(ValueError, match="lengths must lie"):
        torch.func.vmap(lambda p: ops.subtb_loss(p, length + 2, 0.8))(phi)


def test_decode_attention_rule_is_s_separate_calls():
    S, B, C, H, hd = 3, 4, 7, 2, 8
    q, k, v = _rand((S, B, H, hd), 4), _rand((S, B, C, H, hd), 5), \
        _rand((B, C, H, hd), 6)
    kv = torch.tensor([0, 1, 7, 4], dtype=torch.int32)
    out = torch.func.vmap(ops.decode_attention,
                          in_dims=(0, 0, None, None))(q, k, v, kv)
    out1 = torch.func.vmap(ops.decode_attention,
                           in_dims=(1, 1, None, None))(
        q.movedim(0, 1), k.movedim(0, 1), v, kv)
    for s in range(S):
        want = ops.decode_attention(q[s], k[s], v, kv)
        assert torch.equal(out[s], want) and torch.equal(out1[s], want)


def test_decode_step_has_no_rule():
    from repro_torch.core.policies import TransformerPolicy
    pol = TransformerPolicy(5, 4, 8, num_layers=1, dim=16, num_heads=2,
                            device=CPU)
    kw = pol.kernel_weights()
    cache = pol.cache_init(2)

    def step(x):
        return ops.decode_step(kw["stacked"], x, cache,
                               torch.zeros(2, dtype=torch.int32), 1,
                               torch.zeros(2, 8), torch.ones(2, 8,
                                                             dtype=torch.bool),
                               kw["w_out"], kw["b_out"], num_heads=2)[1]

    with pytest.raises(RuntimeError, match="no batching rule"):
        torch.func.vmap(step)(_rand((3, 2, 16), 7))
