"""Continuously batched sampling service of the port (single device)."""
from .api import SampleRequest, SampleResult, validate_request
from .engine import EngineResult, SamplingEngine
from .errors import BadRequest, EngineFailure, ServeError
from .scheduler import Scheduler

__all__ = ["SampleRequest", "SampleResult", "validate_request",
           "EngineResult", "SamplingEngine", "BadRequest", "EngineFailure",
           "ServeError", "Scheduler"]
