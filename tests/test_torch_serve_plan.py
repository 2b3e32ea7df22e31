"""The serving engine's sharded lane pool (``plan="data_parallel"``), the
port's counterparts of the sharded cases of ``tests/test_serve_scale.py``
(same names; bitseq n=8, k=2 and hypergrid 2x5 on the CPU): the pool cut
into D shards over the plan's devices, here the CPU repeated (JAX's
virtual CPU devices' counterpart), each stepped and refilled on its own.
The oracle is the port's ``forward_rollout`` and the single pool: every
sample bitwise.  The environment-variable defaults are held in child
processes by ``tests/test_torch_serve_scale.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.algo.plan import DataParallelPlan, make_plan  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.envs.registry import make_env  # noqa: E402
from repro_torch.serve import (SampleRequest, SamplingEngine,  # noqa: E402
                               Scheduler)
from repro_torch.serve.errors import LanePoisoned  # noqa: E402
from repro_torch.serve.faults import FaultPlan  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
BITSEQ = {"n": 8, "k": 2}


def _plan(d=4):
    return DataParallelPlan(devices=[CPU] * d)


@pytest.fixture(scope="module")
def bitseq8_setup():
    env = make_env("bitseq", **BITSEQ)
    return env, env.init(CPU), recipes.get("bitseq").make_policy(env,
                                                                 device=CPU)


@pytest.fixture(scope="module")
def single_engine(bitseq8_setup):
    return SamplingEngine(*bitseq8_setup, num_lanes=3)


@pytest.fixture(scope="module")
def dp_engine(bitseq8_setup):
    # 6 requested lanes must round up to 8 (a multiple of the 4 shards)
    return SamplingEngine(*bitseq8_setup, num_lanes=6, plan=_plan())


def test_sharded_lane_rounding(dp_engine):
    """num_lanes is rounded up to a shard multiple (6 -> 8 on 4 shards),
    each shard a slice of 2 lanes."""
    assert dp_engine.num_lanes == 8
    assert dp_engine.plan.describe() == {
        "plan": "data_parallel", "device_count": 4, "mesh_shape": [4]}
    assert [lane.t.shape[0] for lane in dp_engine.lanes] == [2] * 4


def test_sharded_engine_matches_forward_rollout(bitseq8_setup, dp_engine):
    """7 samples through an 8-lane/4-shard pool: several refill waves with
    ragged shard occupancy, still bitwise the solo forward_rollout batch."""
    env, ep, pol = bitseq8_setup
    ref = forward_rollout(7, env, ep, pol, 7)
    rid = dp_engine.submit(num_samples=7, seed=7)
    res = dp_engine.run()[rid]
    assert np.array_equal(res.samples, ref.obs[-1].numpy())
    assert np.array_equal(res.log_rewards, ref.log_reward.numpy())


def test_sharded_mixed_temperature_pool(bitseq8_setup, dp_engine,
                                        single_engine):
    """Mixed-temperature co-tenants on a sharded pool reproduce their
    single-pool runs: beta scales rewards exactly, a tempered request
    matches the same request on the unsharded engine bitwise."""
    env, ep, pol = bitseq8_setup
    rid_plain = dp_engine.submit(num_samples=2, seed=3)
    rid_beta = dp_engine.submit(num_samples=2, seed=3, reward_beta=2.0)
    rid_temp = dp_engine.submit(num_samples=2, seed=3, logit_temp=0.5)
    out = dp_engine.run()
    plain, beta, temp = out[rid_plain], out[rid_beta], out[rid_temp]
    ref = forward_rollout(3, env, ep, pol, 2)
    assert np.array_equal(plain.samples, ref.obs[-1].numpy())
    assert np.array_equal(plain.log_rewards, ref.log_reward.numpy())
    assert np.array_equal(beta.samples, plain.samples)
    assert np.array_equal(beta.log_rewards, 2.0 * plain.log_rewards)
    rid_solo = single_engine.submit(num_samples=2, seed=3, logit_temp=0.5)
    solo = single_engine.run()[rid_solo]
    assert np.array_equal(temp.samples, solo.samples)
    assert np.array_equal(temp.log_rewards, solo.log_rewards)


def test_sharded_full_obs_hypergrid():
    """The full-observation tier shards identically: hypergrid on 4
    shards is bitwise forward_rollout."""
    env = make_env("hypergrid", dim=2, side=5)
    ep = env.init(CPU)
    pol = recipes.get("hypergrid").make_policy(env, device=CPU)
    eng = SamplingEngine(env, ep, pol, num_lanes=4, plan=_plan())
    ref = forward_rollout(19, env, ep, pol, 6)
    rid = eng.submit(num_samples=6, seed=19)
    res = eng.run()[rid]
    assert np.array_equal(res.samples, ref.obs[-1].numpy())
    assert np.array_equal(res.log_rewards, ref.log_reward.numpy())


def test_scheduler_data_parallel_round_trip(bitseq8_setup):
    """Scheduler(plan=..., devices=...) builds sharded engines that stay
    bitwise through the full SampleRequest -> SampleResult path (a count
    of shards on the CPU device: all on the CPU)."""
    env, ep, pol = bitseq8_setup
    sched = Scheduler(num_lanes=6, plan="data_parallel", devices=4,
                      device="cpu")
    rid = sched.submit(SampleRequest(env="bitseq", num_samples=5, seed=9,
                                     overrides=BITSEQ))
    res = sched.run(only=(rid,))[rid]
    ref = forward_rollout(9, env, ep, pol, 5)
    assert np.array_equal(np.asarray(res.samples), ref.obs[-1].numpy())
    assert np.array_equal(np.asarray(res.log_rewards),
                          ref.log_reward.numpy())
    eng = next(iter(sched._engines.values()))
    assert eng.num_lanes == 8 and eng.plan.describe()["device_count"] == 4


def test_scheduler_plan_devices_must_exist():
    """The default devices of a D-shard pool are cuda:0 .. cuda:D-1: a box
    with fewer raises; nothing picks a device silently."""
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        make_plan("data_parallel", devices=2).serve_devices()
    assert make_plan("data_parallel", devices=["cpu"] * 3
                     ).serve_devices() == [CPU] * 3


def test_resize_rounds_to_shard_multiple(bitseq8_setup):
    eng = SamplingEngine(*bitseq8_setup, num_lanes=4, plan=_plan())
    rid = eng.submit(num_samples=2, seed=41)
    ref = eng.run()[rid]
    assert eng.resize(5) is True
    assert eng.num_lanes == 8           # 5 -> 8 on 4 shards
    rid2 = eng.submit(num_samples=2, seed=41)
    res = eng.run()[rid2]
    assert np.array_equal(res.samples, ref.samples)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_pool_equals_single_pool(bitseq8_setup, shards):
    """Many requests at once, more samples than lanes, with dedup on: the
    sharded pool's results equal the single pool's, request by request,
    and a request cancelled mid-flight frees its lanes on every shard."""
    reqs = [(1, 5, 1.0, 1.0), (2, 9, 0.7, 2.0), (1, 5, 1.0, 1.0),
            (3, 1, 1.3, 1.0), (4, 11, 1.0, 0.5)]

    def serve(plan):
        eng = SamplingEngine(*bitseq8_setup, num_lanes=6, plan=plan,
                             dedup_cache_size=8)
        ids = [eng.submit(num_samples=n, seed=s, logit_temp=t,
                          reward_beta=b) for s, n, t, b in reqs]
        gone = eng.submit(num_samples=12, seed=99)
        eng.step()
        eng.step()
        assert eng.cancel(gone)["num_samples"] == 12
        out = eng.run()
        assert gone not in out and not eng._occupied.any()
        return eng, [out[i] for i in ids]

    one, want = serve(None)
    eng, got = serve(_plan(shards))
    assert eng.counters["dedup_joins"] == one.counters["dedup_joins"] == 1
    for a, b in zip(want, got):
        assert np.array_equal(a.samples, b.samples)
        assert np.array_equal(a.log_rewards, b.log_rewards)
        assert np.array_equal(a.steps, b.steps)


def test_poisoned_lane_on_any_shard_is_caught(bitseq8_setup):
    """A lane_state fault poisons the occupied lanes of every shard; the
    drain raises LanePoisoned naming lanes by their global index."""
    eng = SamplingEngine(*bitseq8_setup, num_lanes=4, plan=_plan(2),
                         fault_plan=FaultPlan.single("lane_state", at=(1,)))
    eng.submit(num_samples=4, seed=5)
    with pytest.raises(LanePoisoned) as e:
        eng.run()
    assert sorted(e.value.extra["lanes"]) == [0, 1, 2, 3]


@pytest.mark.parametrize("copied", [False, True], ids=["shared", "copied"])
def test_shard_devices_serve_the_callers_params(monkeypatch, copied):
    """A shard serves the caller's env params, not the env's defaults: on
    the engine's device, spelled another way (``torch.device("cpu")`` and
    ``"cpu"``), it shares the engine's policy and params; taken as another
    device (the device check forced, as one CPU has no other device), it
    serves from copies of both.  Either way its samples and log-rewards
    are bitwise the single pool's."""
    from repro_torch.serve import engine as engine_mod
    env = make_env("bitseq", **BITSEQ)
    ep = make_env("bitseq", seed=1, beta=5.0, **BITSEQ).init(CPU)
    assert float(ep.reward_params["beta"]) != float(
        env.init(CPU).reward_params["beta"])
    pol = recipes.get("bitseq").make_policy(env, device=CPU)
    single = SamplingEngine(env, ep, pol, num_lanes=4)
    if copied:
        monkeypatch.setattr(engine_mod, "_same_device", lambda a, b: False)
    eng = SamplingEngine(env, ep, pol, num_lanes=4, plan=DataParallelPlan(
        devices=[torch.device("cpu"), "cpu"]))
    for dev, p, params in eng._shard_ctx:
        assert dev == CPU
        assert (p is not pol and params is not ep) if copied else (
            p is pol and params is ep)
    rids = [e.submit(num_samples=5, seed=13) for e in (single, eng)]
    out = [e.run()[r] for e, r in zip((single, eng), rids)]
    assert np.array_equal(out[0].samples, out[1].samples)
    assert np.array_equal(out[0].log_rewards, out[1].log_rewards)
