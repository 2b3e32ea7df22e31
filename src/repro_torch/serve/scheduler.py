"""Request scheduler: coalesces requests into engines (port of
``repro.serve.scheduler``, without transforms, plans, fault injection or
the refresh onto a newer checkpoint).

Requests are grouped by their engine key ``(env, overrides, checkpoint,
step)``, which pins the environment and policy an engine serves; the
policy params come from ``CheckpointManager.restore_subtree`` when the
request names a checkpoint (the latest complete step unless it names one),
else from the scheduler's seed.  Sample count, seed and both
temperatures are lane-resident state inside one engine, so requests that
differ only in those share a device batch.  Engines are built lazily from
:mod:`repro_torch.recipes` and persist across :meth:`Scheduler.run` calls.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from .. import recipes
from ..device import DeviceLike, resolve_device
from .api import SampleRequest, SampleResult, result_from_engine, \
    validate_request
from .engine import SamplingEngine
from .errors import BadRequest


def _engine_key(req: SampleRequest) -> Tuple:
    return (req.env, tuple(sorted(req.overrides.items())), req.checkpoint,
            req.step)


class Scheduler:
    """Routes :class:`SampleRequest`\\ s to per-(env, overrides) engines.

    ``num_lanes`` sizes each engine's lane pool; ``init_seed`` seeds env
    and policy parameters, so scheduler instances are reproducible;
    ``device`` is where every engine runs (``None`` means ``cuda``)."""

    def __init__(self, num_lanes: int = 16, init_seed: int = 0,
                 device: DeviceLike = None):
        self.num_lanes = int(num_lanes)
        self.init_seed = int(init_seed)
        self.device = resolve_device(device)
        self._engines: Dict[Tuple, SamplingEngine] = {}
        self._routes: Dict[int, Tuple[Tuple, int, SampleRequest]] = {}
        self._next_id = 0

    def _build_engine(self, req: SampleRequest) -> SamplingEngine:
        try:
            recipe = recipes.get(req.env)
        except KeyError as e:
            raise BadRequest(str(e.args[0])) from None
        env = recipe.make_env(**req.overrides)
        env_params = env.init(self.device)
        policy = recipe.make_policy(env, seed=self.init_seed,
                                    device=self.device)
        if req.checkpoint is not None:
            from ..checkpoint import CheckpointManager
            mgr = CheckpointManager(req.checkpoint)
            step = req.step if req.step is not None else mgr.latest_step()
            if step is None:
                raise BadRequest(f"no complete checkpoint found in "
                                 f"{req.checkpoint!r}")
            try:
                mgr.restore_subtree(step, policy.params.flat())
            except (OSError, ValueError) as e:
                raise BadRequest(str(e)) from None
            policy.weights_replaced()
        return SamplingEngine(env, env_params, policy,
                              num_lanes=self.num_lanes)

    def engine_for(self, req: SampleRequest) -> SamplingEngine:
        key = _engine_key(req)
        if key not in self._engines:
            self._engines[key] = self._build_engine(req)
        return self._engines[key]

    @property
    def num_engines(self) -> int:
        return len(self._engines)

    def submit(self, req: SampleRequest) -> int:
        """Validate and queue a request; returns a scheduler-global id."""
        validate_request(req)
        key = _engine_key(req)
        local = self.engine_for(req).submit(
            num_samples=req.num_samples, seed=req.seed,
            logit_temp=req.logit_temp, reward_beta=req.reward_beta)
        rid = self._next_id
        self._next_id += 1
        self._routes[rid] = (key, local, req)
        return rid

    def run(self, only: Optional[Iterable[int]] = None
            ) -> Dict[int, SampleResult]:
        """Drain the engines with queued work (only those serving the
        request ids in ``only``, when given) and return the completed
        results keyed by scheduler-global id."""
        if only is None:
            keys = set(self._engines)
        else:
            keys = {self._routes[rid][0] for rid in only
                    if rid in self._routes}
        per_engine = {k: self._engines[k].run() for k in keys
                      if k in self._engines}
        out: Dict[int, SampleResult] = {}
        for rid, (key, local, req) in list(self._routes.items()):
            res = per_engine.get(key, {}).get(local)
            if res is not None:
                out[rid] = result_from_engine(req, res, rid)
                del self._routes[rid]
        return out
