"""Request and result types of the serving tier (port of the request
surface of ``repro.serve.api``; the port has no HTTP endpoint yet).

The port accepts the JAX package's request fields except ``transforms``
and ``deadline_s``, which it does not serve yet;
:meth:`SampleRequest.from_dict` rejects them as unknown fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from .errors import BadRequest

#: default upper bound on a single request's sample count
DEFAULT_MAX_NUM_SAMPLES = 4096


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One sampling request.

    env          servable environment name (``repro_torch.recipes``)
    num_samples  trajectories to sample
    seed         request seed: same (env, seed) => same samples, whatever
                 the batching (the engine's parity contract)
    logit_temp   forward-logit scale of this request's lanes
    reward_beta  reward exponent beta (R -> R^beta) of this request's lanes
    overrides    env-factory overrides, e.g. bitseq ``{"n": 16, "k": 4}``
    checkpoint   checkpoint directory to load the policy params from (a
                 training checkpoint of either package, through
                 ``CheckpointManager.restore_subtree``); None: a fresh
                 policy from the scheduler's seed
    step         checkpoint step (default: the latest complete one)
    """
    env: str
    num_samples: int = 1
    seed: int = 0
    logit_temp: float = 1.0
    reward_beta: float = 1.0
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoint: Optional[str] = None
    step: Optional[int] = None

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
        req = cls(**d)
        validate_request(req, max_num_samples=max_num_samples)
        return req


def _check_int(name: str, v: Any) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise BadRequest(f"'{name}' must be an integer, got {v!r}")
    return v


def validate_request(req: SampleRequest,
                     max_num_samples: int = DEFAULT_MAX_NUM_SAMPLES) -> None:
    """Every rejection is a :class:`BadRequest` naming the field."""
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
    if not isinstance(req.overrides, dict) or \
            not all(isinstance(k, str) for k in req.overrides):
        raise BadRequest("'overrides' must be an object with string keys")
    if req.checkpoint is not None and not isinstance(req.checkpoint, str):
        raise BadRequest(f"'checkpoint' must be a string path or null, "
                         f"got {req.checkpoint!r}")
    if req.step is not None:
        _check_int("step", req.step)


@dataclasses.dataclass(frozen=True)
class SampleResult:
    """A completed request: ``samples[i]`` is sample i's terminal
    observation, ``steps[i]`` its trajectory length, ``latency_s`` the
    submit-to-drain wall time inside the engine."""
    request_id: int
    env: str
    samples: list
    log_rewards: list
    steps: list
    latency_s: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def result_from_engine(request: SampleRequest, engine_result,
                       request_id: int) -> SampleResult:
    return SampleResult(
        request_id=request_id, env=request.env,
        samples=engine_result.samples.tolist(),
        log_rewards=[float(x) for x in engine_result.log_rewards],
        steps=[int(x) for x in engine_result.steps],
        latency_s=float(engine_result.latency_s))
