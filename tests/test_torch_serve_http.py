"""The port's HTTP surface and command line against the JAX package's:
``/envs`` is JAX's ``_envs_doc`` body, every error class has JAX's code
and kind, ``SampleRequest.from_dict`` accepts and rejects the same
documents, ``ising`` and ``box`` are refused as unservable, and the
one-shot CLI serves each of the seven servable envs at its registry smoke
overrides on the CPU.  Servers listen on port 0 and are shut down in the
test that starts them.
"""
import json
import os
import signal
import subprocess
import sys
import threading
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import api as jax_api  # noqa: E402
from repro.serve import errors as jax_errors  # noqa: E402
from repro_torch import recipes  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.envs.registry import get_env, make_env  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import (BadRequest, SampleRequest,  # noqa: E402
                               Scheduler, ServeFront, api, errors,
                               make_server)

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
SERVABLE = ["amp", "bitseq", "dag", "hypergrid", "phylo", "qm9", "tfbind8"]
ERRORS = ["ServeError", "BadRequest", "QueueTimeout", "TooManyRequests",
          "EngineFailure", "LanePoisoned", "QueueFull", "ShuttingDown",
          "DeadlineExceeded"]
#: documents from_dict must treat as JAX's does
DOCS = [
    [1, 2], {"env": "bitseq", "bogus": 1}, {"num_samples": 2},
    {"env": "bitseq", "num_samples": 0}, {"env": "bitseq",
                                          "num_samples": 10**9},
    {"env": "bitseq", "num_samples": True},
    {"env": "bitseq", "logit_temp": float("nan")},
    {"env": "bitseq", "reward_beta": -1.0},
    {"env": "bitseq", "transforms": "not-a-list"},
    {"env": "bitseq", "transforms": [3]},
    {"env": "bitseq", "seed": "seven"},
    {"env": "bitseq", "deadline_s": 0.0},
    {"env": "bitseq", "deadline_s": float("inf")},
    {"env": "bitseq", "deadline_s": True},
    {"env": "bitseq", "checkpoint": 3}, {"env": "bitseq", "step": 1.5},
    {"env": "bitseq", "overrides": {"n": 16}, "transforms": ["beta=2.0"],
     "deadline_s": 2.5, "logit_temp": 0, "step": 3},
    {"env": "", "num_samples": 1},
    {"env": "hypergrid", "num_samples": 4096, "reward_beta": 3},
]


def _post(port, doc):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/sample", json.dumps(doc),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), json.loads(resp.read())
    conn.close()
    return out


def _get(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


@pytest.fixture
def front_server():
    front = ServeFront(Scheduler(num_lanes=3, device="cpu"),
                       checkpoint_poll_s=None)
    server = make_server(front, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield front, server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    front.shutdown(drain=True, timeout=30)


def _reference(env_name, overrides, seed, n):
    env = make_env(env_name, **overrides)
    ep = env.init(CPU)
    pol = recipes.get(env_name).make_policy(env, device=CPU)
    return forward_rollout(seed, env, ep, pol, n)


def test_http_round_trip_and_observability(front_server):
    front, port = front_server
    for env_name, ov in (("bitseq", {"n": 16, "k": 4}),
                         ("hypergrid", {"dim": 2, "side": 6})):
        status, _, doc = _post(port, {"env": env_name, "num_samples": 3,
                                      "seed": 9, "reward_beta": 2.0,
                                      "overrides": ov})
        assert status == 200, doc
        ref = _reference(env_name, ov, 9, 3)
        np.testing.assert_array_equal(np.asarray(doc["samples"]),
                                      ref.obs[-1].numpy())
        np.testing.assert_array_equal(
            np.asarray(doc["log_rewards"], np.float32),
            (torch.tensor(2.0) * ref.log_reward).numpy())
        assert doc["env"] == env_name and doc["deduped"] is False
    status, _, doc = _post(port, {"env": "bitseq", "num_samples": 3,
                                  "seed": 9, "reward_beta": 2.0,
                                  "overrides": {"n": 16, "k": 4}})
    assert status == 200 and doc["deduped"] is True
    status, hz = _get(port, "/healthz")
    assert status == 200 and hz["status"] == "ok" and hz["runners"] == 2
    status, st = _get(port, "/stats")
    assert status == 200 and st["counters"]["submitted"] == 3
    assert sum(e["engine"]["dedup_hits"] for e in st["engines"]) == 1
    status, doc = _get(port, "/nowhere")
    assert status == 404 and doc["kind"] == "bad_request"


def test_envs_doc_is_jax_envs_doc(front_server):
    _, port = front_server
    status, doc = _get(port, "/envs")
    assert status == 200
    assert doc == json.loads(json.dumps(jax_api._envs_doc()))
    assert doc == api._envs_doc()


@pytest.mark.parametrize("env_name", ["ising", "box"])
def test_unservable_envs_are_refused(front_server, env_name):
    _, port = front_server
    status, _, doc = _post(port, {"env": env_name})
    assert status == 400 and doc["kind"] == "bad_request"
    assert "not servable" in doc["error"]
    with pytest.raises(BadRequest, match="not servable"):
        Scheduler(device="cpu").submit(SampleRequest(env=env_name))
    with pytest.raises(KeyError):
        recipes.get(env_name)
    assert get_env(env_name).serving == "none"
    assert env_name not in recipes.names()


def test_malformed_bodies_are_typed_400s(front_server):
    _, port = front_server
    status, _, doc = _post(port, {"env": "bitseq", "num_samples": 0})
    assert status == 400 and "num_samples" in doc["error"]
    conn = HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/sample", "{not json",
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    assert json.loads(resp.read())["kind"] == "bad_request"
    conn.close()


def test_error_classes_match_jax():
    for name in ERRORS:
        mine, theirs = getattr(errors, name), getattr(jax_errors, name)
        assert (mine.code, mine.kind) == (theirs.code, theirs.kind), name
        kw = dict(extra={"collected": 2}, retry_after_s=2.6)
        a, b = mine("detail", **kw), theirs("detail", **kw)
        assert a.to_dict() == b.to_dict() and a.headers() == b.headers()
        assert mine("x").headers() == {} == theirs("x").headers()
    assert issubclass(errors.BadRequest, ValueError)
    assert all(issubclass(getattr(errors, n), errors.ServeError)
               for n in ERRORS)


@pytest.mark.parametrize("doc", DOCS, ids=range(len(DOCS)))
def test_from_dict_agrees_with_jax(doc):
    def outcome(cls):
        try:
            return "ok", repr(sorted(vars(cls.from_dict(doc)).items()))
        except BadRequest as e:
            return "bad", str(e)
        except jax_errors.BadRequest as e:
            return "bad", str(e)

    assert outcome(SampleRequest) == outcome(jax_api.SampleRequest)


def test_single_threaded_endpoint_round_trip():
    sched = Scheduler(num_lanes=2, device="cpu")
    server = make_server(sched, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        status, _, doc = _post(port, {"env": "hypergrid", "num_samples": 2,
                                      "seed": 3,
                                      "overrides": {"dim": 2, "side": 6}})
        assert status == 200
        ref = _reference("hypergrid", {"dim": 2, "side": 6}, 3, 2)
        np.testing.assert_array_equal(np.asarray(doc["samples"]),
                                      ref.obs[-1].numpy())
        status, _, doc = _post(port, {"env": "box"})
        assert status == 400
        status, envs = _get(port, "/envs")
        assert status == 200 and envs == api._envs_doc()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("env_name", SERVABLE)
def test_launch_serve_one_shot_for_every_servable_env(env_name, capsys):
    rc = serve_cli.main(["--env", env_name, "--smoke", "--device", "cpu",
                         "--num-samples", "3", "--seed", "7", "--lanes", "2",
                         "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    ref = _reference(env_name, get_env(env_name).smoke_overrides, 7, 3)
    np.testing.assert_array_equal(np.asarray(doc["samples"]),
                                  ref.obs[-1].numpy())
    assert np.isfinite(doc["log_rewards"]).all()


def test_launch_serve_http_drains_on_sigterm():
    """``--http`` in a child process: answer a request, then SIGTERM
    drains the front and the process exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--port", "0", "--device", "cpu", "--lanes", "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), line
        port = int(line.split(":")[2].split()[0])
        status, _, doc = _post(port, {"env": "bitseq", "num_samples": 2,
                                      "overrides": {"n": 16, "k": 4}})
        assert status == 200 and len(doc["samples"]) == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert '"drained": true' in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_transforms_are_served_and_key_the_engine():
    """A request's transform stack wraps the registry's env (innermost
    first) and is part of the engine key."""
    sched = Scheduler(num_lanes=3, device="cpu")
    base = dict(env="hypergrid", num_samples=3, seed=5,
                overrides={"dim": 2, "side": 6})
    specs = ("time_limit:limit=8", "beta=2.0")
    a = sched.submit(SampleRequest(transforms=specs, **base))
    b = sched.submit(SampleRequest(**base))
    out = sched.run()
    assert sched.num_engines == 2
    env = make_env("hypergrid", transforms=specs, dim=2, side=6)
    ep = env.init(CPU)
    pol = recipes.get("hypergrid").make_policy(env, device=CPU)
    ref = forward_rollout(5, env, ep, pol, 3)
    np.testing.assert_array_equal(np.asarray(out[a].samples),
                                  ref.obs[-1].numpy())
    np.testing.assert_array_equal(np.asarray(out[a].log_rewards, np.float32),
                                  ref.log_reward.numpy())
    assert max(out[a].steps) <= 8
    assert out[a].log_rewards != out[b].log_rewards    # beta 2 vs 1
    with pytest.raises(BadRequest, match="cannot build"):
        sched.submit(SampleRequest(transforms=("no_such_transform",),
                                   **base))


def test_serving_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--env", "bitseq", "--smoke"])


@pytest.mark.parametrize("seed", [0, 7, 123, 2**31 - 1])
def test_fault_plan_schedule_matches_jax(seed):
    """A seeded plan with rate specs at all four points (two at
    ``restore``, sharing that point's draw) fires at the same occurrences
    as JAX's ``FaultPlan`` of the same seed, and reports the same stats."""
    from repro.serve import faults as jax_faults
    from repro_torch.serve import faults

    def plan(mod):
        return mod.FaultPlan(
            [mod.FaultSpec("engine_step", at=(3,), rate=0.3),
             mod.FaultSpec("latency", rate=0.5, latency_s=0.01),
             mod.FaultSpec("lane_state", rate=0.1),
             mod.FaultSpec("restore", rate=0.2, detail="a"),
             mod.FaultSpec("restore", rate=0.6, detail="b")], seed=seed)

    assert faults.POINTS == jax_faults.POINTS
    ours, theirs = plan(faults), plan(jax_faults)
    order = [p for _ in range(200) for p in faults.POINTS]
    got = [[(s.point, s.rate, s.detail) for s in ours.fires(p)]
           for p in order]
    want = [[(s.point, s.rate, s.detail) for s in theirs.fires(p)]
            for p in order]
    assert got == want
    assert any(got) and not all(got)
    assert ours.stats() == theirs.stats()
