"""Request scheduler: coalesces requests into engines (port of
``repro.serve.scheduler``).

Requests are grouped by their engine key ``(env, transforms, overrides,
checkpoint, step)``, which pins the environment and policy an engine
serves.  Sample count, seed and both temperatures are lane-resident state
inside one engine, so requests that differ only in those share a device
batch.

Engines are built lazily from the env registry
(:mod:`repro_torch.envs.registry`), as the JAX scheduler builds them:
:func:`repro_torch.recipes.get` refuses an entry whose ``serving`` column
is ``"none"`` and names its default recipe's ``make_policy``, the
entry's factory and the request's transform stack make the env, whose parameters come from
``CheckpointManager.restore_subtree`` when the request names a checkpoint
(the latest complete step unless it names one), else from the
scheduler's seed.  Engines persist across :meth:`Scheduler.run` calls.

The surface :mod:`repro_torch.serve.front` uses: engine construction and
eviction hold a lock, so per-key runner threads build their engines
concurrently; :meth:`Scheduler.evict` quarantines an engine;
:meth:`Scheduler.refresh_if_stale` drops an engine whose ``step=None``
checkpoint directory has a newer complete step; a
:class:`~repro_torch.serve.faults.FaultPlan` is handed to every engine and
consulted at each build (the ``restore`` point).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

from .. import recipes
from ..device import DeviceLike, resolve_device
from ..envs.registry import make_env
from .api import SampleRequest, SampleResult, result_from_engine, \
    validate_request
from .engine import SamplingEngine
from .errors import BadRequest


def _engine_key(req: SampleRequest) -> Tuple:
    return (req.env, tuple(req.transforms),
            tuple(sorted(req.overrides.items())), req.checkpoint, req.step)


class Scheduler:
    """Routes :class:`SampleRequest`\\ s to per-(env, checkpoint) engines.

    ``num_lanes`` sizes each engine's lane pool; ``init_seed`` seeds fresh
    policy parameters, so scheduler instances are reproducible; ``device``
    is where every engine runs (``None`` means ``cuda``).  ``fault_plan``
    (tests and chaos runs) injects failures; ``max_step_retries`` /
    ``retry_backoff_s`` configure each engine's retry loop.
    ``dedup_cache_size`` bounds each engine's LRU of results served to
    duplicate requests (0 turns dedup off; on by default, as in JAX).
    ``plan`` / ``devices`` (defaults from ``REPRO_SERVE_PLAN`` /
    ``REPRO_SERVE_DEVICES``, as in JAX) shard every engine's lane pool: a
    ``"data_parallel"`` plan over ``devices`` shards, a count (on
    ``cuda:0 .. cuda:D-1``, or D shards on the CPU when ``device`` is the
    CPU) or a list of devices that may repeat
    (:class:`repro_torch.algo.plan.DataParallelPlan`); one plan serves
    every engine."""

    def __init__(self, num_lanes: int = 16, init_seed: int = 0,
                 device: DeviceLike = None, fault_plan=None,
                 max_step_retries: int = 2, retry_backoff_s: float = 0.02,
                 plan=None, devices=None,
                 dedup_cache_size: int = 64):
        if plan is None:
            plan = os.environ.get("REPRO_SERVE_PLAN") or None
        if devices is None and os.environ.get("REPRO_SERVE_DEVICES"):
            devices = int(os.environ["REPRO_SERVE_DEVICES"])
        self._plan = None
        dev = resolve_device(device)
        if plan is not None:
            from ..algo.plan import make_plan
            if dev.type == "cpu" and plan == "data_parallel" and (
                    devices is None or isinstance(devices, int)):
                # the CPU has no device index: D shards all on it
                devices = [dev] * (devices or 1)
            self._plan = make_plan(plan, devices=devices)
            if self._plan.name not in ("single", "data_parallel"):
                raise ValueError(
                    f"SamplingEngine supports plan 'single' or "
                    f"'data_parallel', got {self._plan.name!r} (the lane "
                    "pool has no seed axis)")
            if self._plan.name == "data_parallel":
                self._plan.serve_devices()      # the devices must exist
        self.plan_spec = plan
        self.devices = devices
        self.num_lanes = int(num_lanes)
        self.init_seed = int(init_seed)
        self.device = dev
        self.fault_plan = fault_plan
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.dedup_cache_size = int(dedup_cache_size)
        self._engines: Dict[Tuple, SamplingEngine] = {}
        #: per key: the checkpoint directory its engine loaded from, the
        #: step it resolved, whether the request pinned the step (a pinned
        #: engine never refreshes) and how often the key was rebuilt
        self._engine_meta: Dict[Tuple, Dict[str, Any]] = {}
        self._routes: Dict[int, Tuple[Tuple, int, SampleRequest]] = {}
        self._next_id = 0
        self._lock = threading.RLock()

    # -- engine construction -------------------------------------------------
    def _build_engine(self, req: SampleRequest) -> SamplingEngine:
        if self.fault_plan is not None:
            # the checkpoint-restore fault point: a firing spec makes this
            # build raise InjectedFault (the front answers a typed 500);
            # the occurrence counter has moved, so the next build can pass
            self.fault_plan.maybe_raise("restore")
        try:
            recipe = recipes.get(req.env)
        except KeyError as e:
            raise BadRequest(str(e.args[0])) from None
        try:
            env = make_env(req.env, transforms=tuple(req.transforms),
                           **dict(req.overrides))
        except (KeyError, TypeError, ValueError) as e:
            raise BadRequest(f"cannot build env {req.env!r}: "
                             f"{type(e).__name__}: {e}") from None
        env_params = env.init(self.device)
        policy = recipe.make_policy(env, seed=self.init_seed,
                                    device=self.device)
        loaded_step = None
        if req.checkpoint is not None:
            from ..checkpoint import CheckpointManager
            mgr = CheckpointManager(req.checkpoint)
            step = req.step if req.step is not None else mgr.latest_step()
            if step is None:
                raise BadRequest(f"no complete checkpoint found in "
                                 f"{req.checkpoint!r}")
            try:
                mgr.restore_subtree(step, policy.params.flat())
            except (OSError, ValueError, KeyError) as e:
                raise BadRequest(str(e)) from None
            if hasattr(policy, "weights_replaced"):
                policy.weights_replaced()
            loaded_step = int(step)
        engine = SamplingEngine(env, env_params, policy,
                                num_lanes=self.num_lanes, plan=self._plan,
                                dedup_cache_size=self.dedup_cache_size,
                                fault_plan=self.fault_plan,
                                max_step_retries=self.max_step_retries,
                                retry_backoff_s=self.retry_backoff_s)
        key = _engine_key(req)
        self._engine_meta[key] = {
            "checkpoint": req.checkpoint, "step": loaded_step,
            "pinned": req.step is not None,
            "rebuilds": self._engine_meta.get(key, {}).get("rebuilds", -1)
            + 1}
        return engine

    def engine_for(self, req: SampleRequest) -> SamplingEngine:
        key = _engine_key(req)
        with self._lock:
            if key not in self._engines:
                self._engines[key] = self._build_engine(req)
            return self._engines[key]

    def evict(self, key: Tuple) -> bool:
        """Quarantine an engine: drop it, so the next request for its key
        builds a fresh one.  Returns whether an engine was dropped."""
        with self._lock:
            return self._engines.pop(key, None) is not None

    def checkpoint_step(self, key: Tuple) -> Optional[int]:
        """The checkpoint step the key's engine loaded (None for fresh
        parameters or a key never built)."""
        with self._lock:
            return self._engine_meta.get(key, {}).get("step")

    def refresh_if_stale(self, req: SampleRequest) -> Optional[int]:
        """If ``req``'s engine follows a checkpoint directory's latest step
        (a ``step=None`` request) and a newer complete checkpoint has
        appeared, evict the engine so the next build serves the new
        parameters; returns that step, else None.  Pinned engines never
        refresh."""
        key = _engine_key(req)
        with self._lock:
            meta = self._engine_meta.get(key)
            if (meta is None or meta["checkpoint"] is None or meta["pinned"]
                    or key not in self._engines):
                return None
            from ..checkpoint import CheckpointManager
            newer = CheckpointManager(meta["checkpoint"]).newer_than(
                meta["step"])
            if newer is None:
                return None
            del self._engines[key]
            return int(newer)

    @property
    def num_engines(self) -> int:
        with self._lock:
            return len(self._engines)

    # -- request surface -----------------------------------------------------
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
        """Drain the engines with queued work or held results and return
        the completed results keyed by scheduler-global id.  ``only``
        restricts the drain to the engines serving those ids, so a caller
        does not pay for other engines' backlogs; co-tenants of a drained
        engine finish with it and are returned too."""
        with self._lock:
            if only is None:
                engines = dict(self._engines)
            else:
                keys = {self._routes[rid][0] for rid in only
                        if rid in self._routes}
                engines = {k: self._engines[k] for k in keys
                           if k in self._engines}
        # a dedup LRU hit completes at submit with no lane work, so an
        # engine may hold results with has_work False
        per_engine = {k: e.run() for k, e in engines.items()
                      if e.has_work or e.has_results}
        out: Dict[int, SampleResult] = {}
        for rid, (key, local, req) in list(self._routes.items()):
            res = per_engine.get(key, {}).get(local)
            if res is not None:
                out[rid] = result_from_engine(req, res, rid)
                del self._routes[rid]
        return out
