"""Typed serving errors (port of ``repro.serve.errors``): every failure
mode of the serving stack maps to exactly one of these, and every one of
these maps to exactly one HTTP status.

========  ====================  ==============================================
status    kind                  raised when
========  ====================  ==============================================
400       ``bad_request``       malformed JSON / failed request validation
                                (unknown field, out-of-range ``num_samples``,
                                non-finite temperature, unservable env, ...)
408       ``queue_timeout``     the request's deadline expired while it was
                                still waiting in the admission queue — no
                                engine work was done on its behalf
429       ``too_many_requests`` one client exceeded its in-flight request cap
                                (``max_inflight_per_client``)
500       ``engine_failure``    the engine failed repeatedly (retries
                                exhausted), an engine (re)build failed, or an
                                unexpected exception escaped the stack
500       ``lane_poisoned``     drain-time validation caught malformed lane
                                output (non-finite log-reward, impossible
                                step count); the pool is quarantined and
                                rebuilt — later requests are unaffected
503       ``queue_full``        the bounded admission queue is full
                                (backpressure; carries ``Retry-After``)
503       ``shutting_down``     the front is draining (SIGTERM) and admits
                                no new work
504       ``deadline_exceeded`` the deadline expired mid-execution; the
                                response carries partial-progress metadata
                                (samples collected / requested, lanes freed)
========  ====================  ==============================================

The contract the fault-injection suite pins
(``tests/test_torch_serve_front.py``, ``scripts/serve_chaos_torch.py``):
*every* request terminates with either a correct result or one of these —
never a hung client, never a silently dropped connection.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class ServeError(Exception):
    """Base typed serving error: ``code`` is the HTTP status, ``kind`` the
    stable machine-readable discriminator, ``extra`` structured metadata
    (partial progress, retry hints) serialized into the response body."""

    code: int = 500
    kind: str = "engine_failure"

    def __init__(self, detail: str, *, extra: Optional[Dict[str, Any]] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(detail)
        self.detail = detail
        self.extra = dict(extra or {})
        self.retry_after_s = retry_after_s

    def to_dict(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"error": self.detail, "kind": self.kind}
        if self.retry_after_s is not None:
            doc["retry_after_s"] = round(float(self.retry_after_s), 3)
        if self.extra:
            doc.update(self.extra)
        return doc

    def headers(self) -> Dict[str, str]:
        if self.retry_after_s is not None:
            return {"Retry-After": str(max(1, int(round(self.retry_after_s))))}
        return {}


class BadRequest(ServeError, ValueError):
    """Also a ValueError so pre-existing ``except ValueError`` request
    paths (CLI, legacy single-threaded handler) keep catching it."""
    code = 400
    kind = "bad_request"


class QueueTimeout(ServeError):
    """Deadline expired while the request was still queued (no engine work
    was done; retrying with a longer deadline is safe and cheap)."""
    code = 408
    kind = "queue_timeout"


class TooManyRequests(ServeError):
    code = 429
    kind = "too_many_requests"


class EngineFailure(ServeError):
    code = 500
    kind = "engine_failure"


class LanePoisoned(ServeError):
    """Drain-time validation caught malformed lane output.  Raising this
    quarantines the engine: the front rebuilds it and replays every
    incomplete request (bitwise-safe — replay is keyed by request seed)."""
    code = 500
    kind = "lane_poisoned"


class QueueFull(ServeError):
    code = 503
    kind = "queue_full"


class ShuttingDown(ServeError):
    code = 503
    kind = "shutting_down"


class DeadlineExceeded(ServeError):
    """Deadline expired mid-execution.  ``extra`` carries partial progress:
    ``collected``/``num_samples`` (samples finished before cancellation) and
    ``lanes_freed`` (in-flight lanes returned to the pool)."""
    code = 504
    kind = "deadline_exceeded"
