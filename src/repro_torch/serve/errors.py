"""Typed serving errors (the subset of ``repro.serve.errors`` the port's
engine and request validation raise).  ``code`` is the HTTP status the
JAX package's front maps each one to."""
from __future__ import annotations



class ServeError(Exception):
    """Base typed serving error: ``code`` is the HTTP status, ``kind`` a
    stable machine-readable name."""

    code: int = 500
    kind: str = "engine_failure"


class BadRequest(ServeError):
    """Malformed request or failed validation (400)."""
    code = 400
    kind = "bad_request"


class EngineFailure(ServeError):
    """The engine could not complete its work (500)."""
    code = 500
    kind = "engine_failure"
