"""Serving front end (port of ``repro.serve.api``): request and result
types and the HTTP JSON surface, on the standard library alone.

    POST /sample   {"env": "bitseq", "num_samples": 4, "seed": 7,
                    "logit_temp": 0.8, "reward_beta": 2.0,
                    "transforms": [], "overrides": {"n": 16, "k": 4},
                    "checkpoint": "checkpoints/bitseq_tb", "step": null,
                    "deadline_s": 30.0}
    GET  /envs     registry listing with each env's serving tier
    GET  /healthz  liveness and drain state (front endpoint only)
    GET  /stats    queue depths, lane occupancy, latency percentiles,
                   retry / eviction / dedup counters (front endpoint only)

Every failure maps to a typed :mod:`repro_torch.serve.errors` error and
one HTTP status (see that module's table).  From the command line::

    python -m repro_torch.launch.serve --env bitseq --smoke --num-samples 4
    python -m repro_torch.launch.serve --http --port 8777
"""
from __future__ import annotations

import dataclasses
import json
import math
import signal
import threading
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from typing import Any, Dict, Optional, Tuple

from .errors import BadRequest, ServeError

#: default upper bound on a single request's sample count; configurable on
#: the front (``max_num_samples``) and enforced by request validation
DEFAULT_MAX_NUM_SAMPLES = 4096


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One sampling request.

    env          registered environment name
                 (:mod:`repro_torch.envs.registry`)
    num_samples  trajectories to sample
    seed         request seed — requests are reproducible by
                 construction: same (env, checkpoint, seed) => same samples,
                 regardless of batching (the engine parity contract)
    logit_temp   per-request forward-logit scale (tempered policy)
    reward_beta  per-request reward exponent β served through the engine's
                 RewardExponent params layer (R -> R^β)
    transforms   env-transform specs stacked onto the env (innermost first)
    overrides    env-factory overrides (``--set`` surface), e.g. bitseq
                 ``{"n": 16, "k": 4}``
    checkpoint   checkpoint directory to load the policy params from (a
                 training checkpoint of either package, through
                 ``CheckpointManager.restore_subtree``); None: a fresh
                 policy from the scheduler's seed
    step         checkpoint step (default: latest complete)
    deadline_s   per-request deadline: expiry while queued returns 408,
                 expiry mid-execution cancels the request's lanes and
                 returns 504 with partial-progress metadata (front only;
                 None defers to the front's default)
    """
    env: str
    num_samples: int = 1
    seed: int = 0
    logit_temp: float = 1.0
    reward_beta: float = 1.0
    transforms: Tuple[str, ...] = ()
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoint: Optional[str] = None
    step: Optional[int] = None
    deadline_s: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any],
                  max_num_samples: int = DEFAULT_MAX_NUM_SAMPLES
                  ) -> "SampleRequest":
        if not isinstance(d, dict):
            raise BadRequest("request body must be a JSON object, got "
                             f"{type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise BadRequest(f"unknown request field(s) {unknown}; "
                             f"accepted: {sorted(known)}")
        if "env" not in d:
            raise BadRequest("request needs an 'env' field")
        d = dict(d)
        if "transforms" in d:
            if not isinstance(d["transforms"], (list, tuple)):
                raise BadRequest("'transforms' must be a list of specs, got "
                                 f"{type(d['transforms']).__name__}")
            d["transforms"] = tuple(d["transforms"])
        req = cls(**d)
        validate_request(req, max_num_samples=max_num_samples)
        return req


def _check_int(name: str, v: Any) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise BadRequest(f"'{name}' must be an integer, got {v!r}")
    return v


def validate_request(req: SampleRequest,
                     max_num_samples: int = DEFAULT_MAX_NUM_SAMPLES) -> None:
    """Hard request validation — every rejection is a typed
    :class:`BadRequest` naming the offending field.  Shared by
    :meth:`SampleRequest.from_dict` (wire path) and
    :meth:`repro_torch.serve.front.ServeFront.submit` (direct path)."""
    if not isinstance(req.env, str) or not req.env:
        raise BadRequest(f"'env' must be a non-empty string, "
                         f"got {req.env!r}")
    n = _check_int("num_samples", req.num_samples)
    if not 1 <= n <= max_num_samples:
        raise BadRequest(f"'num_samples' must be in [1, {max_num_samples}], "
                         f"got {n}")
    _check_int("seed", req.seed)
    for name in ("logit_temp", "reward_beta"):
        v = getattr(req, name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise BadRequest(f"'{name}' must be a number, got {v!r}")
        if not math.isfinite(v) or v < 0:
            raise BadRequest(f"'{name}' must be finite and non-negative, "
                             f"got {v!r}")
    for t in req.transforms:
        if not isinstance(t, str):
            raise BadRequest(f"'transforms' entries must be strings, "
                             f"got {t!r}")
    if not isinstance(req.overrides, dict) or \
            not all(isinstance(k, str) for k in req.overrides):
        raise BadRequest("'overrides' must be an object with string keys")
    if req.checkpoint is not None and not isinstance(req.checkpoint, str):
        raise BadRequest(f"'checkpoint' must be a string path or null, "
                         f"got {req.checkpoint!r}")
    if req.step is not None:
        _check_int("step", req.step)
    if req.deadline_s is not None:
        v = req.deadline_s
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not math.isfinite(v) or v <= 0:
            raise BadRequest(f"'deadline_s' must be a finite positive "
                             f"number or null, got {v!r}")


@dataclasses.dataclass(frozen=True)
class SampleResult:
    """Completed request: terminal observations + log-rewards per sample.

    ``samples[i]`` is sample i's terminal observation (token grid /
    coordinates — the same layout ``RolloutBatch.obs[-1]`` rows carry);
    ``steps[i]`` its trajectory length; ``latency_s`` the submit-to-drain
    wall time inside the engine.  ``deduped`` marks results served from an
    identical request's computation (in-flight fan-out or engine LRU) —
    bitwise equal to recomputing, by the engine's parity contract.
    """
    request_id: int
    env: str
    samples: list
    log_rewards: list
    steps: list
    latency_s: float
    deduped: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def result_from_engine(request: SampleRequest, engine_result,
                       request_id: int) -> SampleResult:
    return SampleResult(
        request_id=request_id,
        env=request.env,
        samples=engine_result.samples.tolist(),
        log_rewards=[float(x) for x in engine_result.log_rewards],
        steps=[int(x) for x in engine_result.steps],
        latency_s=float(engine_result.latency_s),
        deduped=bool(getattr(engine_result, "dedup", False)))


# ---------------------------------------------------------------------------
# stdlib HTTP endpoints
# ---------------------------------------------------------------------------

def _envs_doc() -> Dict[str, Any]:
    from ..envs.registry import env_names, get_env
    rows = [{"env": n,
             "serving": get_env(n).serving,
             "recipe": get_env(n).recipe,
             "description": get_env(n).description}
            for n in env_names()]
    return {"envs": rows}


class _JSONHandler(BaseHTTPRequestHandler):
    def _reply(self, code: int, doc: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _read_request(self, max_num_samples: int) -> SampleRequest:
        n = int(self.headers.get("Content-Length", 0))
        try:
            doc = json.loads(self.rfile.read(n))
        except json.JSONDecodeError as e:
            raise BadRequest(f"request body is not valid JSON: {e}")
        return SampleRequest.from_dict(doc, max_num_samples=max_num_samples)


def make_handler(scheduler):
    """A single-threaded ``BaseHTTPRequestHandler`` bound to ``scheduler``
    (the legacy blocking front; :func:`make_front_handler` is the hardened
    concurrent one).  Every failure is a structured JSON error: validation
    problems are 400s, anything that escapes the engine — including a crash
    that leaves the request without a result — is a structured 500 instead
    of a dropped connection."""

    class Handler(_JSONHandler):
        def do_GET(self):
            if self.path.rstrip("/") in ("", "/envs"):
                self._reply(200, _envs_doc())
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}",
                                  "kind": "bad_request"})

        def do_POST(self):
            if self.path.rstrip("/") != "/sample":
                self._reply(404, {"error": f"unknown path {self.path!r}",
                                  "kind": "bad_request"})
                return
            try:
                req = self._read_request(DEFAULT_MAX_NUM_SAMPLES)
                rid = scheduler.submit(req)
            except ServeError as e:
                self._reply(e.code, e.to_dict(), e.headers())
                return
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e), "kind": "bad_request"})
                return
            try:
                results = scheduler.run(only=(rid,))
                if rid not in results:
                    self._reply(500, {
                        "error": "request produced no result (engine "
                                 "drained without completing it)",
                        "kind": "engine_failure"})
                    return
                self._reply(200, results[rid].to_dict())
            except ServeError as e:
                self._reply(e.code, e.to_dict(), e.headers())
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}",
                                  "kind": "engine_failure"})

    return Handler


def make_front_handler(front):
    """The hardened concurrent handler over a
    :class:`repro_torch.serve.front.ServeFront`: handlers validate,
    enqueue, and block on a per-request future — no engine work runs on a
    socket thread —
    and every typed :class:`ServeError` maps to its HTTP status (503
    backpressure carries ``Retry-After``, 504 carries partial progress).
    Serve it with ``ThreadingHTTPServer`` so slow requests don't block
    other clients."""

    class Handler(_JSONHandler):
        def do_GET(self):
            path = self.path.rstrip("/")
            if path in ("", "/envs"):
                self._reply(200, _envs_doc())
            elif path == "/healthz":
                doc = front.healthz()
                self._reply(200 if doc["status"] == "ok" else 503, doc)
            elif path == "/stats":
                self._reply(200, front.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}",
                                  "kind": "bad_request"})

        def do_POST(self):
            if self.path.rstrip("/") != "/sample":
                self._reply(404, {"error": f"unknown path {self.path!r}",
                                  "kind": "bad_request"})
                return
            try:
                req = self._read_request(front.max_num_samples)
                result = front.request(req, client=self.client_address[0])
                self._reply(200, result.to_dict())
            except ServeError as e:
                self._reply(e.code, e.to_dict(), e.headers())
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e), "kind": "bad_request"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}",
                                  "kind": "engine_failure"})

    return Handler


def make_server(target, host: str = "127.0.0.1", port: int = 8777):
    """Build the right HTTP server for ``target``: a
    :class:`~repro_torch.serve.front.ServeFront` gets the threaded handler on a
    ``ThreadingHTTPServer`` (concurrent, hardened); a bare
    :class:`~repro_torch.serve.scheduler.Scheduler` keeps the legacy blocking
    single-threaded endpoint."""
    if hasattr(target, "healthz"):        # a ServeFront
        return ThreadingHTTPServer((host, port), make_front_handler(target))
    return HTTPServer((host, port), make_handler(target))


def serve_http(target, host: str = "127.0.0.1", port: int = 8777,
               log=print) -> None:
    """Blocking JSON endpoint over ``target`` (front or scheduler) until
    SIGTERM or ctrl-c.  SIGTERM drains a front (stop admitting with 503
    ``shutting_down``, finish in-flight lanes, flush responses; the report
    is logged as ``drained: {...}``), then stops serving.  The handler is
    installed only on the main thread, and the previous one restored on
    return."""
    server = make_server(target, host, port)
    threaded = isinstance(server, ThreadingHTTPServer)
    device = getattr(getattr(target, "scheduler", target), "device", None)
    log(f"serving on http://{host}:{server.server_address[1]} "
        + (f"on {device} " if device is not None else "")
        + f"({'threaded front' if threaded else 'single-threaded'}; "
        f"POST /sample, GET /envs"
        + (", /healthz, /stats" if threaded else "")
        + "; SIGTERM drains, ctrl-c to stop)")

    def drain(signum, frame):
        # server.shutdown() must come from another thread than
        # serve_forever's, which this handler interrupts
        def stop():
            if threaded:
                report = target.shutdown(drain=True, timeout=60.0)
                log(f"drained: {json.dumps(report)}")
            server.shutdown()
        threading.Thread(target=stop, daemon=True).start()

    main = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, drain) if main else None
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        if threaded:
            target.shutdown(drain=True, timeout=10.0)
    finally:
        server.server_close()
        if main:
            signal.signal(signal.SIGTERM, previous)
