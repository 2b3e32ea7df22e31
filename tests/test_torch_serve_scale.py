"""The port's counterparts of the single-device cases of
``tests/test_serve_scale.py`` (same names, bitseq n=8, k=2 on the CPU):
the lean drain, cross-request dedup, lane-pool resizing and the front's
autosizing.  The oracle is the port's ``forward_rollout``.  The sharded
pool's cases are in ``tests/test_torch_serve_plan.py``; the last tests
here pin the scheduler's and the CLI's plan settings.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from _hyp import given, settings, st

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    POLICY_PARAMS_PREFIX, CheckpointManager)
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.envs.registry import make_env  # noqa: E402
from repro_torch.serve import (SampleRequest, SamplingEngine,  # noqa: E402
                               Scheduler, ServeFront)
from repro_torch.serve.errors import EngineFailure  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
BITSEQ = {"n": 8, "k": 2}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bitseq8_setup():
    env = make_env("bitseq", **BITSEQ)
    return env, env.init(CPU), recipes.get("bitseq").make_policy(env,
                                                                 device=CPU)


@pytest.fixture(scope="module")
def single_engine(bitseq8_setup):
    return SamplingEngine(*bitseq8_setup, num_lanes=3)


@pytest.fixture(scope="module")
def dedup_engine(bitseq8_setup):
    return SamplingEngine(*bitseq8_setup, num_lanes=4, dedup_cache_size=16)


# -- the lean drain --------------------------------------------------------------

def test_zero_completion_drain_is_one_scalar(single_engine):
    eng = single_engine
    before = dict(eng.counters)
    nd = torch.zeros(eng.num_lanes, dtype=torch.bool)
    eng._undrained = (nd, nd.sum())
    assert eng._drain_pending() == 0
    assert eng.counters["drain_skips"] == before["drain_skips"] + 1
    assert eng.counters["drain_packs"] == before["drain_packs"]


def test_lean_drain_counters_over_a_run(single_engine):
    eng = single_engine
    before = dict(eng.counters)
    rid = eng.submit(num_samples=5, seed=77)
    res = eng.run()[rid]
    assert res.samples.shape[0] == 5
    assert eng.counters["drain_skips"] > before["drain_skips"]
    assert eng.counters["drain_packs"] > before["drain_packs"]


def test_cancel_between_dispatch_and_drain(single_engine):
    """A request cancelled after its terminal block but before the drain
    drains as a no-op, not a LanePoisoned false positive."""
    eng = single_engine
    rid = eng.submit(num_samples=1, seed=123)
    for _ in range(10 * eng.T):
        eng.step()
        if eng._undrained is not None and int(eng._undrained[1]):
            break
    else:
        pytest.fail("request never completed a block")
    eng.cancel(rid)
    eng.step()
    assert rid not in eng.take_results()
    assert not eng._occupied.any()
    eng.run()


# -- cross-request dedup -----------------------------------------------------------

_FIELDS = ("seed", "num_samples", "logit_temp", "reward_beta")


@pytest.mark.parametrize("field", _FIELDS)
@given(delta=st.integers(1, 7))
@settings(max_examples=5, deadline=None)
def test_dedup_contract_field_difference_never_shares(dedup_engine, field,
                                                      delta):
    eng = dedup_engine
    base = {"seed": 100 + 10 * _FIELDS.index(field), "num_samples": 2,
            "logit_temp": 1.0, "reward_beta": 1.0}
    pert = dict(base)
    if field == "seed":
        pert["seed"] += delta
    elif field == "num_samples":
        pert["num_samples"] += delta
    elif field == "logit_temp":
        pert["logit_temp"] += delta * 0.125
    else:
        pert["reward_beta"] += delta * 0.25
    eng.submit(**base)
    eng.run()
    c1 = dict(eng.counters)
    rid = eng.submit(**pert)
    out = eng.run()
    assert eng.counters["dedup_hits"] == c1["dedup_hits"]
    assert eng.counters["dedup_joins"] == c1["dedup_joins"]
    assert eng.counters["dedup_misses"] == c1["dedup_misses"] + 1
    assert out[rid].dedup is False


def test_dedup_exact_duplicate_computes_once(dedup_engine):
    eng = dedup_engine
    kw = {"num_samples": 3, "seed": 7000}
    c0 = dict(eng.counters)
    r1 = eng.submit(**kw)
    r2 = eng.submit(**kw)
    assert eng.counters["dedup_joins"] == c0["dedup_joins"] + 1
    out = eng.run()
    steps_after = eng.steps_run
    assert np.array_equal(out[r1].samples, out[r2].samples)
    assert np.array_equal(out[r1].log_rewards, out[r2].log_rewards)
    assert out[r1].dedup is False and out[r2].dedup is True

    r3 = eng.submit(**kw)
    assert eng.counters["dedup_hits"] == c0["dedup_hits"] + 1
    out3 = eng.run()
    assert eng.steps_run == steps_after
    assert out3[r3].dedup is True
    assert np.array_equal(out3[r3].samples, out[r1].samples)
    assert np.array_equal(out3[r3].log_rewards, out[r1].log_rewards)
    assert out3[r3].latency_s == 0.0


def test_dedup_cancel_primary_promotes_waiter(bitseq8_setup, dedup_engine):
    env, ep, pol = bitseq8_setup
    eng = dedup_engine
    kw = {"num_samples": 2, "seed": 7100}
    r1 = eng.submit(**kw)
    r2 = eng.submit(**kw)
    eng.step()
    eng.cancel(r1)
    out = eng.run()
    assert r1 not in out and r2 in out
    ref = forward_rollout(7100, env, ep, pol, 2)
    assert np.array_equal(out[r2].samples, ref.obs[-1].numpy())
    assert np.array_equal(out[r2].log_rewards, ref.log_reward.numpy())


def test_dedup_engine_key_separates_checkpoint_steps(tmp_path,
                                                     bitseq8_setup):
    _, _, pol = bitseq8_setup
    mgr = CheckpointManager(tmp_path)
    tree = {f"{POLICY_PARAMS_PREFIX}/{k}": v
            for k, v in pol.params.flat().items()}
    mgr.save(1, tree)
    mgr.save(2, tree)
    sched = Scheduler(num_lanes=2, device="cpu")
    kw = dict(env="bitseq", num_samples=2, seed=5, overrides=BITSEQ,
              checkpoint=str(tmp_path))
    a = sched.submit(SampleRequest(step=1, **kw))
    b = sched.submit(SampleRequest(step=2, **kw))
    out = sched.run()
    assert sched.num_engines == 2
    for e in sched._engines.values():
        assert e.counters["dedup_hits"] == 0
        assert e.counters["dedup_joins"] == 0
    assert np.array_equal(np.asarray(out[a].samples),
                          np.asarray(out[b].samples))


# -- lane-pool resizing ------------------------------------------------------------

def test_resize_preserves_parity_and_refuses_occupied(bitseq8_setup):
    eng = SamplingEngine(*bitseq8_setup, num_lanes=2)
    rid = eng.submit(num_samples=3, seed=31)
    ref = eng.run()[rid]

    assert eng.resize(5) is True and eng.num_lanes == 5
    assert eng.resize(5) is False
    rid2 = eng.submit(num_samples=3, seed=31)
    res = eng.run()[rid2]
    assert np.array_equal(res.samples, ref.samples)
    assert np.array_equal(res.log_rewards, ref.log_rewards)
    assert eng.counters["resizes"] == 1

    rid3 = eng.submit(num_samples=1, seed=32)
    eng.step()
    with pytest.raises(EngineFailure):
        eng.resize(7)
    out = eng.run()
    assert rid3 in out

    eng.prewarm([2, 8])
    assert eng.num_lanes == 5
    rid4 = eng.submit(num_samples=3, seed=31)
    assert np.array_equal(eng.run()[rid4].samples, ref.samples)


# -- front autosizing ---------------------------------------------------------------

def test_autosize_buckets_are_bounded_powers_of_two():
    front = ServeFront(Scheduler(num_lanes=2, device="cpu"),
                       checkpoint_poll_s=None, autosize=True, min_lanes=2,
                       max_lanes=16)
    try:
        assert front.autosize_buckets() == [2, 4, 8, 16]
    finally:
        front.shutdown(drain=False, timeout=10.0)


def test_front_autosize_grows_then_shrinks(bitseq8_setup):
    sched = Scheduler(num_lanes=2, dedup_cache_size=0, device="cpu")
    front = ServeFront(sched, checkpoint_poll_s=None, autosize=True,
                       min_lanes=2, max_lanes=8, prewarm_lanes=True)
    try:
        base = dict(env="bitseq", overrides=BITSEQ)
        futs = [front.submit(SampleRequest(num_samples=8, seed=500 + i,
                                           **base))
                for i in range(6)]
        for f in futs:
            assert f.result(timeout=120) is not None
        runner = next(iter(front._runners.values()))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and runner.engine.num_lanes <= 2:
            time.sleep(0.05)
        assert runner.engine.num_lanes > 2, "pool never grew after burst"
        rstats = front.stats()["engines"][0]
        assert "arrival_rate_hz" in rstats and "queued_samples" in rstats

        for i in range(3):
            time.sleep(0.3)
            front.request(SampleRequest(num_samples=1, seed=600 + i,
                                        **base))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and runner.engine.num_lanes > 2:
            time.sleep(0.05)
        assert runner.engine.num_lanes == 2, "pool never shrank when idle"
        assert runner.counters["autosize_resizes"] >= 2
        res = front.request(SampleRequest(num_samples=2, seed=700, **base))
        env, ep, pol = bitseq8_setup
        ref = forward_rollout(700, env, ep, pol, 2)
        assert np.array_equal(np.asarray(res.samples), ref.obs[-1].numpy())
    finally:
        front.shutdown(drain=True, timeout=60.0)


# -- plans ---------------------------------------------------------------------

def test_scheduler_refuses_plans_other_than_single():
    """The scheduler's plans: ``single``; ``data_parallel`` over D shards
    (on the CPU device: D shards on the CPU) that every engine takes; a
    device count without a plan stays single, as in JAX; a seed plan is
    refused (the lane pool has no seed axis)."""
    s = Scheduler(plan="single", devices=1, device="cpu")
    assert s.plan_spec == "single" and s.devices == 1
    dp = Scheduler(plan="data_parallel", devices=2, device="cpu",
                   num_lanes=5)
    req = SampleRequest(env="bitseq", overrides={"n": 8, "k": 2},
                        num_samples=3, seed=4)
    rid = dp.submit(req)
    eng = dp.engine_for(req)
    assert eng.plan.name == "data_parallel" and eng.num_lanes == 6
    assert len(eng.lanes) == 2
    single = Scheduler(device="cpu", num_lanes=5)
    want = single.run([single.submit(req)])
    got = dp.run([rid])
    assert np.array_equal(np.asarray(got[rid].samples),
                          np.asarray(next(iter(want.values())).samples))
    assert Scheduler(devices=4, device="cpu")._plan is None
    from repro_torch.algo.plan import VmapSeedsPlan
    with pytest.raises(ValueError, match="no seed axis"):
        Scheduler(plan=VmapSeedsPlan(2), device="cpu")


@pytest.mark.parametrize("var,value", [("REPRO_SERVE_PLAN", "data_parallel"),
                                       ("REPRO_SERVE_DEVICES", "4")])
def test_env_var_plan_defaults_are_refused(var, value):
    """The environment variables supply the defaults, as in JAX: the CLI
    serves under them and exits 0 (a child process with its own
    environment; on the CPU a data-parallel pool's shards all sit on the
    CPU)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **{var: value})
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--env",
         "bitseq", "--smoke", "--device", "cpu", "--num-samples", "3"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("log_r=") == 3
