"""Sampling service of the port: continuously batched engines over every
servable env of the registry, behind a threaded front with deadlines,
backpressure, quarantine and replay, and an HTTP endpoint.

- :class:`~repro_torch.serve.engine.SamplingEngine`: a lane pool per
  (env, policy), the KV-cache tier or the full-observation tier, dedup,
  retry, drain-time validation, resize / prewarm / cancel, sharded over a
  ``data_parallel`` plan's devices;
- :class:`~repro_torch.serve.scheduler.Scheduler`: requests to engines by
  (env, transforms, overrides, checkpoint, step), built from the registry;
- :class:`~repro_torch.serve.front.ServeFront`: bounded admission queues
  feeding a runner thread per engine key;
- :mod:`~repro_torch.serve.errors` (one HTTP status per failure),
  :mod:`~repro_torch.serve.faults` (seeded fault injection),
  :mod:`~repro_torch.serve.api` (request types and the HTTP surface); the
  command line is :mod:`repro_torch.launch.serve`.
"""
from .api import (SampleRequest, SampleResult, make_server, serve_http,
                  validate_request)
from .engine import EngineResult, SamplingEngine
from .errors import (BadRequest, DeadlineExceeded, EngineFailure,
                     LanePoisoned, QueueFull, QueueTimeout, ServeError,
                     ShuttingDown, TooManyRequests)
from .faults import FaultPlan, FaultSpec, InjectedFault
from .front import ServeFront
from .scheduler import Scheduler

__all__ = ["SampleRequest", "SampleResult", "validate_request",
           "serve_http", "make_server", "EngineResult", "SamplingEngine",
           "Scheduler", "ServeFront", "ServeError", "BadRequest",
           "QueueTimeout", "TooManyRequests", "EngineFailure",
           "LanePoisoned", "QueueFull", "ShuttingDown", "DeadlineExceeded",
           "FaultPlan", "FaultSpec", "InjectedFault"]
