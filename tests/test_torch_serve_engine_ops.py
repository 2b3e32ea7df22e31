"""The port's engine pool control next to the same calls on
``repro.serve.SamplingEngine``: dedup hits, joins and misses; ``cancel``'s
three branches; a retried ``engine_step`` fault; a ``lane_state`` fault
(``resize`` and ``prewarm``: ``tests/test_torch_serve_engine_resize.py``).  Both engines draw JAX's noise (the port's
through a replaying noise source) from the same parameters, so results
are compared bitwise, and the counters and returned dicts equal JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serve import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serve import LanePoisoned as JaxLanePoisoned  # noqa: E402
from repro.serve import SamplingEngine as JaxSamplingEngine  # noqa: E402
from repro.serve.errors import EngineFailure as JaxEngineFailure  # noqa
from repro_torch.serve import (EngineFailure, FaultPlan,  # noqa: E402
                               LanePoisoned, SamplingEngine)
from test_torch_serve import jax_replay_noise  # noqa: E402
from test_torch_serve_engine import assert_results_match, pair  # noqa

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tfbind8():
    return pair("tfbind8", {})


@pytest.fixture(scope="module")
def grid():
    return pair("hypergrid", {"dim": 2, "side": 6})


def engines(side_pair, **kw):
    """A JAX engine and a port engine over the same parameters and
    noise, built with the same keyword arguments."""
    (jenv, jpe, jpol, jparams), (tenv, tpe, tpol) = side_pair
    jax_kw = dict(kw)
    if "fault_plan" in kw:
        jax_kw["fault_plan"] = kw["fault_plan"][0]
        kw = dict(kw, fault_plan=kw["fault_plan"][1])
    return (JaxSamplingEngine(jenv, jpe, jpol, jparams, **jax_kw),
            SamplingEngine(tenv, tpe, tpol,
                           noise=jax_replay_noise(tenv.max_steps), **kw))


def assert_same(got, want):
    assert_results_match([got], [want])
    assert got.dedup == want.dedup


def drive(engine, script):
    """Run ``script`` (a list of (op, kwargs)) on ``engine``; returns the
    submitted ids in order, each op's return value and the final results."""
    ids, outs = [], []
    results = {}
    for op, kw in script:
        if op == "submit":
            ids.append(engine.submit(**kw))
            outs.append(ids[-1])
        elif op == "cancel":
            outs.append(engine.cancel(ids[kw["nth"]]))
        elif op == "step":
            outs.append(engine.step())
        elif op == "run":
            results.update(engine.run())
            outs.append(sorted(results))
    return ids, outs, results


def test_dedup_hits_joins_and_misses_match_jax(tfbind8):
    jeng, teng = engines(tfbind8, num_lanes=4, dedup_cache_size=16)
    kw = {"num_samples": 3, "seed": 7000}
    script = [("submit", kw), ("submit", kw),                  # miss, join
              ("submit", dict(kw, logit_temp=0.5)),            # miss
              ("submit", dict(kw, num_samples=2)),             # miss
              ("run", {}),
              ("submit", kw),                                  # LRU hit
              ("submit", dict(kw, reward_beta=2.0)),           # miss
              ("run", {})]
    jids, jouts, jres = drive(jeng, script)
    tids, touts, tres = drive(teng, script)
    assert touts == jouts and tids == jids
    for i in tids:
        assert_same(tres[i], jres[i])
    assert [tres[i].dedup for i in tids] == [False, True, False, False,
                                             True, False]
    assert tres[tids[4]].latency_s == 0.0
    assert teng.counters == jeng.counters
    assert (teng.counters["dedup_hits"], teng.counters["dedup_joins"],
            teng.counters["dedup_misses"]) == (1, 1, 4)


def test_cancel_branches_return_jax_dicts(tfbind8):
    """A waiter is detached; a primary with waiters hands its lanes to the
    first waiter (which completes bitwise); a plain request frees its
    lanes and queued samples."""
    jeng, teng = engines(tfbind8, num_lanes=4, dedup_cache_size=16)
    kw = {"num_samples": 3, "seed": 7100}
    script = [("submit", kw), ("submit", kw), ("submit", kw),
              ("step", {}),
              ("cancel", {"nth": 2}),           # waiter
              ("cancel", {"nth": 0}),           # primary, promote waiter 1
              ("submit", {"num_samples": 6, "seed": 7200}),
              ("step", {}), ("step", {}),
              ("cancel", {"nth": 3}),           # lanes and queue
              ("cancel", {"nth": 3}),           # already gone: zeros
              ("run", {})]
    jids, jouts, jres = drive(jeng, script)
    tids, touts, tres = drive(teng, script)
    assert touts == jouts
    assert touts[4] == {"collected": 0, "num_samples": 3, "lanes_freed": 0,
                        "pending_removed": 0}
    assert touts[9]["lanes_freed"] > 0 and touts[9]["pending_removed"] > 0
    assert set(tres) == {tids[1]}
    assert_same(tres[tids[1]], jres[jids[1]])
    assert teng.counters == jeng.counters
    assert not teng.has_work


def test_transient_step_fault_is_retried_bitwise(grid):
    jeng, teng = engines(grid, num_lanes=3, retry_backoff_s=0.0,
                         fault_plan=(JaxFaultPlan.single("engine_step",
                                                         at=(1, 2)),
                                     FaultPlan.single("engine_step",
                                                      at=(1, 2))))
    _, clean = engines(grid, num_lanes=3)
    rid = clean.submit(num_samples=4, seed=51)
    want = clean.run()[rid]
    for eng in (jeng, teng):
        rid = eng.submit(num_samples=4, seed=51)
        assert_same(eng.run()[rid], want)
    assert teng.counters == jeng.counters
    assert teng.counters["step_retries"] == 2
    assert teng.counters["step_failures"] == 0


def test_persistent_step_fault_raises_engine_failure(grid):
    jeng, teng = engines(grid, num_lanes=3, retry_backoff_s=0.0,
                         max_step_retries=1,
                         fault_plan=(JaxFaultPlan.single("engine_step",
                                                         at=(0, 1)),
                                     FaultPlan.single("engine_step",
                                                      at=(0, 1))))
    for eng, failure in ((jeng, JaxEngineFailure), (teng, EngineFailure)):
        eng.submit(num_samples=2, seed=52)
        with pytest.raises(failure, match="after 2 attempts"):
            eng.run()
    assert teng.counters == jeng.counters


def test_lane_state_fault_raises_lane_poisoned(grid):
    jeng, teng = engines(grid, num_lanes=3,
                         fault_plan=(JaxFaultPlan.single("lane_state"),
                                     FaultPlan.single("lane_state")))
    for eng, poisoned in ((jeng, JaxLanePoisoned), (teng, LanePoisoned)):
        eng.submit(num_samples=3, seed=61)
        with pytest.raises(poisoned) as ei:
            eng.run()
        assert ei.value.code == 500 and ei.value.kind == "lane_poisoned"
        eng.poisoned = ei.value.extra
    assert teng.poisoned == jeng.poisoned


def test_progress_and_occupancy(tfbind8):
    jeng, teng = engines(tfbind8, num_lanes=4)
    for eng in (jeng, teng):
        rid = eng.submit(num_samples=6, seed=80)
        eng.step()
        eng.snap = (eng.progress(rid), eng.occupancy, eng.has_results)
        eng.run()
        eng.snap += (eng.progress(rid),)
    assert teng.snap == jeng.snap
    assert teng.snap[0]["lanes_in_flight"] == 4
