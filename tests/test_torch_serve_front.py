"""The port's hardened front (counterparts of ``tests/test_serve_front.py``,
same names, at small widths on the CPU): every request terminates with a
correct result or a typed :mod:`repro_torch.serve.errors` error, never a
hung client, and every recovery path (retry, quarantine and replay,
checkpoint refresh) keeps the engine parity contract bitwise: a served
request equals the port's ``forward_rollout`` of its seed.

Every front and server a test starts is shut down in the test; servers
listen on port 0.
"""
import json
import threading
import time
from http.client import HTTPConnection
from http.server import HTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    POLICY_PARAMS_PREFIX, CheckpointManager)
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.envs.registry import make_env  # noqa: E402
from repro_torch.serve import (BadRequest, DeadlineExceeded,  # noqa: E402
                               EngineFailure, FaultPlan, FaultSpec,
                               QueueFull, QueueTimeout, SampleRequest,
                               Scheduler, ServeFront, ShuttingDown,
                               TooManyRequests, make_server)
from repro_torch.serve.api import make_handler  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
BITSEQ = dict(env="bitseq", overrides={"n": 16, "k": 4})
GRID = dict(env="hypergrid", overrides={"dim": 2, "side": 6})


def _reference(envspec, seed, num_samples, policy=None):
    """Solo ``forward_rollout`` of a request: the parity oracle."""
    env = make_env(envspec["env"], **envspec["overrides"])
    env_params = env.init(CPU)
    if policy is None:
        policy = recipes.get(envspec["env"]).make_policy(env, device=CPU)
    return forward_rollout(seed, env, env_params, policy, num_samples)


def _same(res, ref):
    return np.array_equal(np.asarray(res.samples), ref.obs[-1].numpy())


def _sched(**kw):
    return Scheduler(device="cpu", **kw)


def _serve(target):
    """A server over ``target`` on a free port, serving on a thread."""
    server = make_server(target, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


# -- validation and fault-plan determinism -------------------------------------

@pytest.mark.parametrize("doc,needle", [
    ([1, 2], "JSON object"),
    ({"env": "bitseq", "bogus": 1}, "bogus"),
    ({"num_samples": 2}, "'env'"),
    ({"env": "bitseq", "num_samples": 0}, "num_samples"),
    ({"env": "bitseq", "num_samples": 10**9}, "num_samples"),
    ({"env": "bitseq", "num_samples": True}, "num_samples"),
    ({"env": "bitseq", "logit_temp": float("nan")}, "logit_temp"),
    ({"env": "bitseq", "reward_beta": -1.0}, "reward_beta"),
    ({"env": "bitseq", "transforms": "not-a-list"}, "transforms"),
    ({"env": "bitseq", "seed": "seven"}, "seed"),
    ({"env": "bitseq", "deadline_s": 0.0}, "deadline_s"),
    ({"env": "bitseq", "deadline_s": float("inf")}, "deadline_s"),
])
def test_from_dict_rejects_with_named_field(doc, needle):
    with pytest.raises(BadRequest, match=needle):
        SampleRequest.from_dict(doc)
    with pytest.raises(ValueError):
        SampleRequest.from_dict(doc)


def test_from_dict_accepts_full_request():
    req = SampleRequest.from_dict(
        {"env": "bitseq", "num_samples": 3, "seed": 5, "logit_temp": 0.8,
         "reward_beta": 2.0, "transforms": [], "overrides": {"n": 16},
         "checkpoint": None, "step": None, "deadline_s": 30.0})
    assert req.num_samples == 3 and req.deadline_s == 30.0
    assert req.transforms == ()


def test_fault_plan_is_deterministic_and_replayable():
    specs = [FaultSpec("engine_step", at=(2,), rate=0.3),
             FaultSpec("latency", rate=0.5, latency_s=0.01)]
    a, b = FaultPlan(specs, seed=123), FaultPlan(specs, seed=123)
    fa = [(bool(a.fires("engine_step")), bool(a.fires("latency")))
          for _ in range(64)]
    fb = [(bool(b.fires("engine_step")), bool(b.fires("latency")))
          for _ in range(64)]
    assert fa == fb
    assert fa[2][0]
    c = FaultPlan(specs, seed=124)
    fc = [(bool(c.fires("engine_step")), bool(c.fires("latency")))
          for _ in range(64)]
    assert fa != fc
    assert a.stats()["engine_step"]["consulted"] == 64


def test_legacy_handler_returns_structured_500_on_missing_result():
    class StubScheduler:
        def submit(self, req):
            return 42

        def run(self, only=None):
            return {}

    server = HTTPServer(("127.0.0.1", 0), make_handler(StubScheduler()))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = HTTPConnection("127.0.0.1", server.server_address[1],
                              timeout=30)
        conn.request("POST", "/sample",
                     json.dumps({"env": "bitseq", "num_samples": 1}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 500
        doc = json.loads(resp.read())
        assert doc["kind"] == "engine_failure"
        assert "no result" in doc["error"]
        conn.close()
    finally:
        _stop(server, thread)


# -- the hammer: concurrent HTTP clients, two envs, bitwise exactly once -------

def test_hammer_concurrent_clients_bitwise_exactly_once():
    front = ServeFront(_sched(num_lanes=3), checkpoint_poll_s=None)
    server, sthread = _serve(front)
    port = server.server_address[1]
    n_threads, n_per = 4, 3
    results, errors, answers = {}, [], []
    lock = threading.Lock()

    def client(tid):
        conn = HTTPConnection("127.0.0.1", port, timeout=120)
        for j in range(n_per):
            envspec = BITSEQ if (tid + j) % 2 == 0 else GRID
            seed = 100 + tid * n_per + j
            body = json.dumps({"env": envspec["env"], "num_samples": 2,
                               "seed": seed,
                               "overrides": envspec["overrides"]})
            try:
                conn.request("POST", "/sample", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                with lock:
                    answers.append(seed)
                    if resp.status != 200:
                        errors.append((seed, resp.status, doc))
                    else:
                        results[(envspec["env"], seed)] = doc
            except Exception as e:
                with lock:
                    errors.append((seed, "exception", repr(e)))
        conn.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors, f"hammer errors: {errors}"
        assert sorted(answers) == list(range(100, 100 + n_threads * n_per))
        assert len(results) == n_threads * n_per
        for (env, seed), doc in results.items():
            ref = _reference(BITSEQ if env == "bitseq" else GRID, seed, 2)
            assert np.array_equal(np.asarray(doc["samples"]),
                                  ref.obs[-1].numpy())
            assert np.array_equal(np.asarray(doc["log_rewards"], np.float32),
                                  ref.log_reward.numpy())
        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        hz = json.loads(conn.getresponse().read())
        assert hz["status"] == "ok" and hz["runners"] == 2
        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        conn.close()
        assert st["counters"]["submitted"] == n_threads * n_per
        assert sum(r["completed"] for r in st["engines"]) \
            == n_threads * n_per
    finally:
        _stop(server, sthread)
        front.shutdown(drain=True, timeout=30)


# -- fault-injection points ----------------------------------------------------

def test_transient_step_fault_is_retried_bitwise():
    sched = _sched(num_lanes=3)
    front = ServeFront(sched, checkpoint_poll_s=None)
    try:
        front.request(SampleRequest(num_samples=3, seed=21, **BITSEQ))
        engine = next(iter(sched._engines.values()))
        engine._faults = FaultPlan.single("engine_step", at=(0,))
        res = front.request(SampleRequest(num_samples=3, seed=22, **BITSEQ))
        assert _same(res, _reference(BITSEQ, 22, 3))
        assert engine.counters["step_retries"] >= 1
        assert engine.counters["step_failures"] == 0
    finally:
        front.shutdown(drain=True, timeout=30)


def test_persistent_step_fault_quarantines_and_replays_bitwise():
    plan = FaultPlan.single("engine_step", at=(0, 1, 2, 3))
    sched = _sched(num_lanes=3, fault_plan=plan, max_step_retries=1,
                   retry_backoff_s=0.001)
    front = ServeFront(sched, checkpoint_poll_s=None)
    try:
        res = front.request(SampleRequest(num_samples=3, seed=31, **BITSEQ))
        ref = _reference(BITSEQ, 31, 3)
        assert _same(res, ref)
        assert np.array_equal(np.asarray(res.log_rewards, np.float32),
                              ref.log_reward.numpy())
        st = front.stats()
        assert st["counters"]["evictions"] >= 1
        assert st["counters"]["replays"] >= 1
    finally:
        front.shutdown(drain=True, timeout=30)


def test_lane_poison_fault_quarantines_and_replays_bitwise():
    plan = FaultPlan.single("lane_state", at=(0,))
    sched = _sched(num_lanes=3, fault_plan=plan)
    front = ServeFront(sched, checkpoint_poll_s=None)
    try:
        res = front.request(SampleRequest(num_samples=3, seed=41, **BITSEQ))
        assert _same(res, _reference(BITSEQ, 41, 3))
        assert all(np.isfinite(res.log_rewards))
        assert front.stats()["counters"]["evictions"] >= 1
        res2 = front.request(SampleRequest(num_samples=2, seed=42, **BITSEQ))
        assert _same(res2, _reference(BITSEQ, 42, 2))
    finally:
        front.shutdown(drain=True, timeout=30)


def test_restore_fault_fails_typed_then_recovers():
    plan = FaultPlan.single("restore", at=(0,))
    front = ServeFront(_sched(num_lanes=3, fault_plan=plan),
                       checkpoint_poll_s=None)
    try:
        with pytest.raises(EngineFailure, match="injected fault"):
            front.request(SampleRequest(num_samples=2, seed=51, **BITSEQ))
        res = front.request(SampleRequest(num_samples=2, seed=51, **BITSEQ))
        assert _same(res, _reference(BITSEQ, 51, 2))
    finally:
        front.shutdown(drain=True, timeout=30)


def test_deadline_mid_execution_returns_504_with_partial_progress():
    plan = FaultPlan([FaultSpec("latency", rate=1.0, latency_s=0.25)],
                     seed=7)
    front = ServeFront(_sched(num_lanes=3, fault_plan=plan),
                       checkpoint_poll_s=None)
    try:
        front.request(SampleRequest(num_samples=1, seed=61, **BITSEQ))
        with pytest.raises(DeadlineExceeded) as ei:
            front.request(SampleRequest(num_samples=9, seed=62, **BITSEQ),
                          deadline_s=0.3)
        err = ei.value
        assert err.code == 504
        assert err.extra["num_samples"] == 9
        assert 0 <= err.extra["collected"] < 9
        assert err.extra["elapsed_s"] >= 0.3
        res = front.request(SampleRequest(num_samples=2, seed=63, **BITSEQ))
        assert _same(res, _reference(BITSEQ, 63, 2))
    finally:
        front.shutdown(drain=True, timeout=30)


# -- typed rejections: 408 / 429 / 503 / drain ------------------------------------

def test_deadline_expired_in_queue_returns_408():
    front = ServeFront(_sched(num_lanes=3), checkpoint_poll_s=None)
    try:
        with pytest.raises(QueueTimeout) as ei:
            front.request(SampleRequest(num_samples=1, seed=71, **BITSEQ),
                          deadline_s=1e-6)
        assert ei.value.code == 408
        assert "queued_s" in ei.value.extra
    finally:
        front.shutdown(drain=True, timeout=30)


def test_per_client_inflight_cap_returns_429():
    plan = FaultPlan([FaultSpec("latency", rate=1.0, latency_s=0.2)],
                     seed=3)
    front = ServeFront(_sched(num_lanes=3, fault_plan=plan),
                       checkpoint_poll_s=None, max_inflight_per_client=1)
    try:
        fut = front.submit(SampleRequest(num_samples=2, seed=81, **BITSEQ),
                           client="10.0.0.1")
        with pytest.raises(TooManyRequests) as ei:
            front.submit(SampleRequest(num_samples=2, seed=82, **BITSEQ),
                         client="10.0.0.1")
        assert ei.value.code == 429
        fut2 = front.submit(SampleRequest(num_samples=2, seed=83, **BITSEQ),
                            client="10.0.0.2")
        assert fut.result(timeout=120) is not None
        assert fut2.result(timeout=120) is not None
        fut3 = front.submit(SampleRequest(num_samples=1, seed=84, **BITSEQ),
                            client="10.0.0.1")
        assert fut3.result(timeout=120) is not None
    finally:
        front.shutdown(drain=True, timeout=30)


def test_full_queue_returns_503_with_retry_after():
    plan = FaultPlan([FaultSpec("latency", rate=1.0, latency_s=0.4)],
                     seed=5)
    front = ServeFront(_sched(num_lanes=3, fault_plan=plan), max_queue=1,
                       checkpoint_poll_s=None)
    futs = []
    try:
        futs.append(front.submit(
            SampleRequest(num_samples=2, seed=91, **BITSEQ)))
        time.sleep(0.3)                 # the runner takes r1 off the queue
        futs.append(front.submit(
            SampleRequest(num_samples=2, seed=92, **BITSEQ)))
        with pytest.raises(QueueFull) as ei:
            front.submit(SampleRequest(num_samples=2, seed=93, **BITSEQ))
        assert ei.value.code == 503
        assert ei.value.retry_after_s > 0
        assert "Retry-After" in ei.value.headers()
    finally:
        for f in futs:
            f.result(timeout=120)       # backpressure loses no request
        front.shutdown(drain=True, timeout=30)


def test_drain_finishes_inflight_then_rejects_new_work():
    plan = FaultPlan([FaultSpec("latency", rate=1.0, latency_s=0.1)],
                     seed=9)
    front = ServeFront(_sched(num_lanes=3, fault_plan=plan),
                       checkpoint_poll_s=None)
    fut = front.submit(SampleRequest(num_samples=2, seed=95, **BITSEQ))
    report = front.shutdown(drain=True, timeout=120)
    assert report["drained"] and report["runners_joined"] == 1
    res = fut.result(timeout=1)
    assert _same(res, _reference(BITSEQ, 95, 2))
    with pytest.raises(ShuttingDown):
        front.submit(SampleRequest(num_samples=1, seed=96, **BITSEQ))
    assert front.healthz()["status"] == "draining"


# -- checkpoint refresh and scheduler satellites ----------------------------------

def _save(mgr, step, policy):
    mgr.save(step, {f"{POLICY_PARAMS_PREFIX}/{k}": v.detach()
                    for k, v in policy.params.flat().items()})


def _bitseq_policy():
    env = make_env("bitseq", **BITSEQ["overrides"])
    return recipes.get("bitseq").make_policy(env, device=CPU)


def test_checkpoint_advance_refreshes_engine(tmp_path):
    pol0 = _bitseq_policy()
    pol1 = _bitseq_policy()
    with torch.no_grad():
        for p in pol1.params.parameters():
            p.add_(0.25)
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 1, pol0)

    sched = _sched(num_lanes=3)
    front = ServeFront(sched, checkpoint_poll_s=0.05)
    req = SampleRequest(num_samples=2, seed=11, checkpoint=str(tmp_path),
                        **BITSEQ)
    try:
        r0 = front.request(req)
        key = next(iter(sched._engines))
        assert sched.checkpoint_step(key) == 1
        _save(mgr, 2, pol1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if front.stats()["counters"].get("checkpoint_refreshes", 0) >= 1:
                break
            time.sleep(0.02)
        else:
            pytest.fail("checkpoint refresh never observed")
        r1 = front.request(req)
        meta = sched._engine_meta[key]
        assert meta["step"] == 2 and meta["rebuilds"] >= 1
        served = sched._engines[key].policy
        for a, b in zip(served.params.parameters(), pol1.params.parameters()):
            assert torch.equal(a, b)
        assert r1.samples != r0.samples
        assert _same(r1, _reference(BITSEQ, 11, 2, policy=pol1))
    finally:
        front.shutdown(drain=True, timeout=30)


def test_pinned_step_never_refreshes(tmp_path):
    pol0 = _bitseq_policy()
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 1, pol0)
    sched = _sched(num_lanes=3)
    req = SampleRequest(num_samples=1, seed=1, checkpoint=str(tmp_path),
                        step=1, **BITSEQ)
    sched.engine_for(req)
    _save(mgr, 2, pol0)
    assert sched.refresh_if_stale(req) is None
    key = next(iter(sched._engines))
    assert sched.checkpoint_step(key) == 1


def test_scheduler_run_only_drains_just_that_engine():
    sched = _sched(num_lanes=3)
    r_bit = sched.submit(SampleRequest(num_samples=2, seed=1, **BITSEQ))
    r_grid = sched.submit(SampleRequest(num_samples=2, seed=1, **GRID))
    assert sched.num_engines == 2
    out = sched.run(only=(r_bit,))
    assert r_bit in out and r_grid not in out
    # an engine holding only a dedup result is drained too
    r_dup = sched.submit(SampleRequest(num_samples=2, seed=1, **BITSEQ))
    out2 = sched.run()
    assert r_grid in out2 and r_dup in out2 and out2[r_dup].deduped
    assert out2[r_dup].samples == out[r_bit].samples
