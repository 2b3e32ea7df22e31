"""The hardened serving front (port of ``repro.serve.front``): concurrent
admission, deadlines, backpressure and graceful degradation over the
engines.

- **Threaded admission.**  :meth:`ServeFront.submit` validates, routes the
  request to a *bounded* per-engine-key admission queue, and returns a
  future; HTTP handlers block on the future — no engine work runs on a
  socket thread.  A dedicated :class:`_EngineRunner` thread per engine key
  owns that key's engine exclusively (engines are single-threaded by
  construction) and continuously batches everything in its queue into the
  engine's lane pool.
- **Backpressure.**  A full admission queue rejects immediately with a
  typed 503 ``queue_full`` carrying a ``Retry-After`` estimate (EWMA of
  recent request service time x queue depth); an optional per-client
  in-flight cap returns 429.
- **Deadlines.**  Enforced between ``steps_per_sync`` blocks: expiry while
  queued is a cheap 408 (no engine work done); expiry mid-execution
  cancels the request's lanes (returning them to the pool) and fails the
  future with a 504 carrying partial-progress metadata.
- **Graceful degradation.**  Transient step failures retry with backoff
  inside the engine; exhausted retries, poisoned lanes (drain-time
  validation), and stalls quarantine the engine — the runner evicts it,
  rebuilds from the scheduler, and *replays* every incomplete request onto
  the fresh engine.  The port's noise is a hash of (seed, sample, step),
  so replayed results are bitwise those of an undisturbed run (the engine
  parity contract survives every recovery path).
- **Checkpoint refresh.**  Runners poll the checkpoint directory of
  ``step=None`` engines; when training publishes a newer complete
  checkpoint the engine is evicted mid-flight — in-flight requests finish
  on the params they started with (parity), queued requests are served by
  the rebuilt engine at the new step.
- **Clean drain.**  :meth:`ServeFront.shutdown` (wired to SIGTERM by
  ``repro_torch.launch.serve``) stops admitting (503 ``shutting_down``),
  finishes in-flight lanes, flushes every response, and joins the runner
  threads.
- **Lane-pool autosizing.**  With ``autosize=True`` each runner tracks an
  EWMA of its arrival rate, service time, and request size; between
  requests (never under an occupied pool) it resizes its engine across
  power-of-two lane-count buckets sized to the estimated demand
  (Little's law: arrivals/s x service time x samples/request, or the
  samples already queued, whichever is larger).  Buckets bound the number
  of distinct pool shapes, and ``prewarm_lanes=True`` runs a block at
  each of them when the engine is built, so a resize mid-serve pays no
  first-use cost.  The engine's parity contract is lane-count-invariant,
  so results are unaffected.
- **Observability.**  :meth:`healthz` and :meth:`stats` expose drain
  state, queue depths, lane occupancy, arrival-rate estimates, per-engine
  latency percentiles, and retry/eviction/replay/dedup counters —
  degradation is visible, not silent.

Every request terminates with either a correct result or a typed
:mod:`repro_torch.serve.errors` error; ``tests/test_torch_serve_front.py``
and ``scripts/serve_chaos_torch.py`` hammer this contract under seeded
:class:`~repro_torch.serve.faults.FaultPlan`\\ s.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .api import (DEFAULT_MAX_NUM_SAMPLES, SampleRequest, SampleResult,
                  result_from_engine, validate_request)
from .errors import (BadRequest, DeadlineExceeded, EngineFailure, QueueFull,
                     QueueTimeout, ServeError, ShuttingDown, TooManyRequests)
from .scheduler import Scheduler, _engine_key


class _Item:
    """One admitted request riding through a runner: the original request,
    its completion future, and its (absolute, monotonic) deadline."""

    __slots__ = ("req", "future", "deadline", "enqueue_t", "client",
                 "engine_rid")

    def __init__(self, req: SampleRequest, deadline: Optional[float],
                 client: Optional[str]):
        self.req = req
        self.future: Future = Future()
        self.deadline = deadline
        self.enqueue_t = time.monotonic()
        self.client = client
        self.engine_rid: Optional[int] = None

    def fail(self, err: ServeError) -> bool:
        if self.future.done():
            return False
        self.future.set_exception(err)
        return True

    def complete(self, result: SampleResult) -> bool:
        if self.future.done():
            return False
        self.future.set_result(result)
        return True


class _EngineRunner(threading.Thread):
    """Dedicated driver thread for one engine key: admits items from its
    bounded queue, drives the engine block by block, enforces
    deadlines between blocks, and owns the quarantine/rebuild/replay
    recovery path.  Only this thread ever touches its engine."""

    #: blocks with zero lane completions (at full worst-case trajectory
    #: coverage) before the pool is declared stalled and quarantined
    _STALL_FACTOR = 6

    def __init__(self, front: "ServeFront", key: Tuple,
                 template: SampleRequest):
        super().__init__(name=f"engine-runner-{template.env}", daemon=True)
        self.front = front
        self.key = key
        self.template = template
        self.queue: "queue.Queue[_Item]" = queue.Queue(
            maxsize=front.max_queue)
        self.inflight: Dict[int, _Item] = {}
        self.engine = None
        self.dead = False
        self.stop_now = threading.Event()      # hard stop: fail everything
        self.stop_after_drain = threading.Event()
        self.counters = {"admitted": 0, "completed": 0, "deadline_504": 0,
                         "queue_408": 0, "rebuilds": 0, "replayed": 0,
                         "refreshes": 0, "autosize_resizes": 0}
        self._latencies: List[float] = []
        self._ewma_s = 0.5                     # request service-time EWMA
        self._arrival_rate = 0.0               # requests/s EWMA
        self._avg_samples = 4.0                # samples/request EWMA
        self._queued_samples = 0               # submitted, not yet admitted
        self._last_arrival: Optional[float] = None
        self._prewarmed = False
        self._consec_build_failures = 0
        self._refresh_pending = False
        self._last_poll = time.monotonic()
        self._blocks_since_progress = 0
        self._lock = threading.Lock()          # guards latencies/counters

    # -- metrics -------------------------------------------------------------
    def observe_latency(self, dt: float) -> None:
        with self._lock:
            self._latencies.append(dt)
            if len(self._latencies) > 512:
                del self._latencies[:256]
            self._ewma_s += 0.2 * (dt - self._ewma_s)

    def retry_after_estimate(self) -> float:
        with self._lock:
            ewma = self._ewma_s
        return max(0.1, ewma * (self.queue.qsize() + 1))

    def note_arrival(self, num_samples: int) -> None:
        """Fold one accepted submission into the demand estimators that
        drive :meth:`_maybe_autosize` (called from the front's submit
        path, so instantaneous rates are clamped against burst spikes)."""
        now = time.monotonic()
        with self._lock:
            if self._last_arrival is not None:
                dt = max(1e-3, now - self._last_arrival)
                inst = min(1e3, 1.0 / dt)
                self._arrival_rate += 0.3 * (inst - self._arrival_rate)
            self._last_arrival = now
            self._avg_samples += 0.3 * (num_samples - self._avg_samples)
            self._queued_samples += int(num_samples)

    def _maybe_autosize(self) -> None:
        """Grow/shrink the lane pool between requests: pick the
        power-of-two bucket covering the demand estimate — the samples
        already queued, or Little's law (arrival rate x service-time EWMA
        x samples/request) while traffic flows — clamped to
        [min_lanes, max_lanes].  Only runs on an idle pool (resize
        refuses occupied lanes), so in-flight work is never disturbed;
        parity is lane-count-invariant, so results are unaffected."""
        front = self.front
        engine = self.engine
        if not front.autosize or engine is None or self.inflight \
                or engine.has_work:
            return
        now = time.monotonic()
        with self._lock:
            queued = self._queued_samples
            lam = self._arrival_rate
            if self._last_arrival is not None:
                # the EWMA only folds on arrivals; while traffic is quiet
                # the observed rate can't exceed 1/idle-gap, so clamp it —
                # otherwise a past burst pins the pool large forever
                lam = min(lam, 1.0 / max(1e-3, now - self._last_arrival))
            demand = max(float(queued),
                         lam * self._ewma_s * self._avg_samples, 1.0)
        bucket = 1 << max(0, math.ceil(math.log2(demand)))
        bucket = max(front.min_lanes, min(front.max_lanes, bucket))
        try:
            if engine.resize(bucket):
                with self._lock:
                    self.counters["autosize_resizes"] += 1
                front.count("autosize_resizes")
        except Exception:
            pass        # a racing admit occupied the pool; next idle tick

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = list(self._latencies)
            counters = dict(self.counters)
            arrival = self._arrival_rate
            queued_samples = self._queued_samples
        eng = self.engine
        doc: Dict[str, Any] = {
            "env": self.template.env,
            "key": repr(self.key),
            "queue_depth": self.queue.qsize(),
            "inflight_requests": len(self.inflight),
            "dead": self.dead,
            "arrival_rate_hz": round(arrival, 3),
            "queued_samples": queued_samples,
            **counters,
        }
        if lat:
            doc["p50_ms"] = round(float(np.percentile(lat, 50)) * 1e3, 1)
            doc["p99_ms"] = round(float(np.percentile(lat, 99)) * 1e3, 1)
        if eng is not None:
            doc["lanes"] = eng.num_lanes
            doc["lane_occupancy"] = round(eng.occupancy, 3)
            doc["engine"] = dict(eng.counters)
        return doc

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # the runner must never die silently
            self._fail_inflight(EngineFailure(
                f"engine runner crashed: {type(e).__name__}: {e}"))
            self._drain_queue_with(EngineFailure(
                f"engine runner crashed: {type(e).__name__}: {e}"))
        finally:
            self.dead = True

    def _loop(self) -> None:
        while True:
            if self.stop_now.is_set():
                err = ShuttingDown("front stopped without draining")
                self._fail_inflight(err)
                self._drain_queue_with(err)
                return
            if self.stop_after_drain.is_set() and not self.inflight \
                    and self.queue.empty():
                return
            self._admit_available()
            if not self.inflight:
                self._apply_pending_refresh()
                self._maybe_poll_checkpoint()
                self._maybe_autosize()
                try:
                    item = self.queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._admit(item)
                continue
            self._drive_block()

    def _drive_block(self) -> None:
        """One engine block + the between-block bookkeeping: deadline enforcement, result flushing, stall detection,
        checkpoint polling, and continuous admission."""
        engine = self.engine
        try:
            finished = engine.step()
        except Exception as e:
            self._quarantine(e)
            return
        try:
            for rid, res in engine.take_results().items():
                item = self.inflight.pop(rid, None)
                if item is None:
                    continue
                now = time.monotonic()
                self.observe_latency(now - item.enqueue_t)
                with self._lock:
                    self.counters["completed"] += 1
                item.complete(result_from_engine(item.req, res, rid))
            self._enforce_deadlines()
        except Exception as e:
            self._quarantine(e)
            return
        if finished > 0:
            self._blocks_since_progress = 0
        else:
            self._blocks_since_progress += 1
            worst = max(1, math.ceil(engine.T / engine.steps_per_sync))
            if self.inflight and \
                    self._blocks_since_progress > self._STALL_FACTOR * worst:
                self._quarantine(EngineFailure(
                    f"lane pool stalled: no lane finished in "
                    f"{self._blocks_since_progress} blocks "
                    f"(worst-case trajectory is {worst})"))
                return
        self._maybe_poll_checkpoint()

    # -- admission -----------------------------------------------------------
    def _admit_available(self) -> None:
        # while a checkpoint refresh is pending, queued items wait so they
        # get the new params; in-flight items keep their old engine
        while not self._refresh_pending:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                return
            self._admit(item)

    def _admit(self, item: _Item) -> None:
        # a poll may have flagged a refresh in this very loop iteration
        # (after _apply_pending_refresh already ran); apply it now so an
        # idle pool never admits onto params the scheduler has evicted
        self._apply_pending_refresh()
        with self._lock:
            self._queued_samples = max(
                0, self._queued_samples - item.req.num_samples)
        now = time.monotonic()
        if item.deadline is not None and now >= item.deadline:
            with self._lock:
                self.counters["queue_408"] += 1
            item.fail(QueueTimeout(
                f"deadline expired after {now - item.enqueue_t:.3f}s in the "
                "admission queue (no engine work was done)",
                extra={"queued_s": round(now - item.enqueue_t, 3)}))
            return
        if self.engine is None and not self._build_engine(item):
            return
        try:
            rid = self.engine.submit(
                num_samples=item.req.num_samples, seed=item.req.seed,
                logit_temp=item.req.logit_temp,
                reward_beta=item.req.reward_beta)
        except Exception as e:
            item.fail(EngineFailure(
                f"engine rejected the request: {type(e).__name__}: {e}"))
            return
        item.engine_rid = rid
        self.inflight[rid] = item
        with self._lock:
            self.counters["admitted"] += 1

    def _build_engine(self, item: Optional[_Item]) -> bool:
        """(Re)build this key's engine via the scheduler.  On failure the
        triggering item gets a typed error; the build is retried on the
        next admission (fault occurrence counters advance, so injected
        restore failures are transient unless scheduled otherwise)."""
        try:
            self.engine = self.front.scheduler.engine_for(self.template)
            self._consec_build_failures = 0
            self._blocks_since_progress = 0
            if self.front.autosize and self.front.prewarm_lanes \
                    and not self._prewarmed:
                # run a block at every autosize bucket now, so mid-serve
                # resizes pay no first-use cost (best-effort: a failure
                # here only defers that cost)
                self._prewarmed = True
                try:
                    self.engine.prewarm(self.front.autosize_buckets())
                except Exception:
                    pass
            return True
        except Exception as e:
            self._consec_build_failures += 1
            err: ServeError
            if isinstance(e, ServeError):
                err = e
            elif isinstance(e, (ValueError, KeyError)):
                err = BadRequest(str(e))
            else:
                err = EngineFailure(
                    f"engine build failed: {type(e).__name__}: {e}")
            if item is not None:
                item.fail(err)
            if self._consec_build_failures > self.front.max_rebuilds:
                # persistent build failure: don't spin — fail the backlog
                self._drain_queue_with(EngineFailure(
                    f"engine build failed {self._consec_build_failures} "
                    f"times in a row; last error: {err.detail}"))
            return False

    # -- deadlines -----------------------------------------------------------
    def _enforce_deadlines(self) -> None:
        now = time.monotonic()
        expired = [(rid, item) for rid, item in self.inflight.items()
                   if item.deadline is not None and now >= item.deadline]
        for rid, item in expired:
            partial = self.engine.cancel(rid)
            del self.inflight[rid]
            with self._lock:
                self.counters["deadline_504"] += 1
            item.fail(DeadlineExceeded(
                f"deadline expired after "
                f"{now - item.enqueue_t:.3f}s "
                f"({partial['collected']}/{partial['num_samples']} samples "
                "completed before cancellation)",
                extra={"collected": partial["collected"],
                       "num_samples": partial["num_samples"],
                       "lanes_freed": partial["lanes_freed"],
                       "elapsed_s": round(now - item.enqueue_t, 3)}))

    # -- recovery ------------------------------------------------------------
    def _quarantine(self, cause: Exception) -> None:
        """The graceful-degradation path: evict the poisoned engine,
        rebuild it, and replay every incomplete request from scratch.
        Replay is keyed by request seed, so results after recovery are
        bitwise-identical to an undisturbed run."""
        self.front.scheduler.evict(self.key)
        self.front.count("evictions")
        with self._lock:
            self.counters["rebuilds"] += 1
        survivors = list(self.inflight.values())
        self.inflight = {}
        self.engine = None
        self._blocks_since_progress = 0
        if not self._build_engine(None):
            err = cause if isinstance(cause, ServeError) else EngineFailure(
                f"engine quarantined ({type(cause).__name__}: {cause}) and "
                "rebuild failed")
            for item in survivors:
                item.fail(err)
            return
        now = time.monotonic()
        for item in survivors:
            if item.deadline is not None and now >= item.deadline:
                with self._lock:
                    self.counters["deadline_504"] += 1
                item.fail(DeadlineExceeded(
                    "deadline expired during engine recovery",
                    extra={"collected": 0,
                           "num_samples": item.req.num_samples,
                           "lanes_freed": 0,
                           "elapsed_s": round(now - item.enqueue_t, 3)}))
                continue
            with self._lock:
                self.counters["replayed"] += 1
            self.front.count("replays")
            self._admit(item)

    # -- checkpoint refresh ---------------------------------------------------
    def _maybe_poll_checkpoint(self) -> None:
        poll_s = self.front.checkpoint_poll_s
        if poll_s is None or self.template.checkpoint is None \
                or self.template.step is not None or self._refresh_pending:
            return
        now = time.monotonic()
        if now - self._last_poll < poll_s:
            return
        self._last_poll = now
        newer = self.front.scheduler.refresh_if_stale(self.template)
        if newer is not None:
            # the scheduler already evicted its map entry; our self.engine
            # reference keeps serving in-flight requests on the params they
            # started with, and queued requests wait for the rebuild
            self._refresh_pending = True
            with self._lock:
                self.counters["refreshes"] += 1
            self.front.count("checkpoint_refreshes")

    def _apply_pending_refresh(self) -> None:
        if self._refresh_pending and not self.inflight:
            self.engine = None          # next admission rebuilds at the
            self._refresh_pending = False  # new checkpoint step

    # -- teardown helpers -----------------------------------------------------
    def _fail_inflight(self, err: ServeError) -> None:
        items, self.inflight = list(self.inflight.values()), {}
        for item in items:
            item.fail(err)

    def _drain_queue_with(self, err: ServeError) -> None:
        while True:
            try:
                self.queue.get_nowait().fail(err)
            except queue.Empty:
                return


class ServeFront:
    """The concurrent, hardened request front over a :class:`Scheduler`.

    Parameters
    ----------
    scheduler: engine factory/registry; its device, lane count and
        fault plan are the front's.
    max_queue: per-engine-key admission queue bound; a full queue rejects
        with 503 ``queue_full`` + ``Retry-After``.
    default_deadline_s: deadline applied when a request carries none
        (None = no deadline).
    max_num_samples: per-request sample-count bound (400 beyond it).
    max_inflight_per_client: per-client concurrent request cap (429
        beyond it; None = unlimited).
    checkpoint_poll_s: how often runners probe ``step=None`` checkpoint
        directories for newer steps (None disables refresh).
    max_rebuilds: consecutive engine-build failures tolerated before the
        backlog is failed fast.
    hard_timeout_s: absolute ceiling on :meth:`request` waits — the
        never-hang backstop for deadline-less requests.
    autosize: let runners grow/shrink their engines' lane pools between
        requests, across power-of-two buckets in [min_lanes, max_lanes]
        sized to the EWMA demand estimate (see the module docs).
    min_lanes / max_lanes: autosizing bucket bounds (max_lanes defaults
        to max(64, the scheduler's num_lanes)).
    prewarm_lanes: run a block at every autosize bucket at engine
        build time.
    """

    def __init__(self, scheduler: Scheduler, *, max_queue: int = 64,
                 default_deadline_s: Optional[float] = None,
                 max_num_samples: int = DEFAULT_MAX_NUM_SAMPLES,
                 max_inflight_per_client: Optional[int] = None,
                 checkpoint_poll_s: Optional[float] = 1.0,
                 max_rebuilds: int = 2, hard_timeout_s: float = 600.0,
                 autosize: bool = False,
                 min_lanes: int = 2, max_lanes: Optional[int] = None,
                 prewarm_lanes: bool = False):
        self.scheduler = scheduler
        self.autosize = bool(autosize)
        self.min_lanes = max(1, int(min_lanes))
        self.max_lanes = (int(max_lanes) if max_lanes is not None
                          else max(64, self.scheduler.num_lanes))
        self.prewarm_lanes = bool(prewarm_lanes)
        self.max_queue = int(max_queue)
        self.default_deadline_s = default_deadline_s
        self.max_num_samples = int(max_num_samples)
        self.max_inflight_per_client = max_inflight_per_client
        self.checkpoint_poll_s = checkpoint_poll_s
        self.max_rebuilds = int(max_rebuilds)
        self.hard_timeout_s = float(hard_timeout_s)
        self._runners: Dict[Tuple, _EngineRunner] = {}
        self._client_inflight: Dict[str, int] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._draining = False
        self._t0 = time.monotonic()

    # -- bookkeeping ---------------------------------------------------------
    def autosize_buckets(self) -> List[int]:
        """The power-of-two lane-count buckets autosizing moves between —
        the set :meth:`_EngineRunner._maybe_autosize` picks from and
        ``prewarm_lanes`` runs up front."""
        out, b = [], 1
        while b <= self.max_lanes:
            if b >= self.min_lanes:
                out.append(b)
            b *= 2
        return out or [self.min_lanes]

    def count(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def _runner_for(self, req: SampleRequest) -> _EngineRunner:
        key = _engine_key(req)
        with self._lock:
            runner = self._runners.get(key)
            if runner is None or runner.dead:
                runner = _EngineRunner(self, key, req)
                self._runners[key] = runner
                runner.start()
            return runner

    def _track_client(self, client: Optional[str], fut: Future) -> None:
        if client is None or self.max_inflight_per_client is None:
            return
        with self._lock:
            n = self._client_inflight.get(client, 0)
            if n >= self.max_inflight_per_client:
                raise TooManyRequests(
                    f"client has {n} requests in flight "
                    f"(cap {self.max_inflight_per_client})",
                    retry_after_s=1.0)
            self._client_inflight[client] = n + 1

        def release(_):
            with self._lock:
                left = self._client_inflight.get(client, 1) - 1
                if left <= 0:
                    self._client_inflight.pop(client, None)
                else:
                    self._client_inflight[client] = left

        fut.add_done_callback(release)

    # -- request surface -----------------------------------------------------
    def submit(self, req: SampleRequest, *,
               deadline_s: Optional[float] = None,
               client: Optional[str] = None) -> Future:
        """Validate and enqueue; returns the request's completion future.
        Raises typed errors for every rejection (never blocks on engine
        work — that happens on the runner thread)."""
        if self._draining:
            raise ShuttingDown("front is draining; not admitting requests",
                               retry_after_s=5.0)
        validate_request(req, max_num_samples=self.max_num_samples)
        deadline_rel = deadline_s if deadline_s is not None \
            else (req.deadline_s if req.deadline_s is not None
                  else self.default_deadline_s)
        deadline = (time.monotonic() + float(deadline_rel)
                    if deadline_rel is not None else None)
        item = _Item(req, deadline, client)
        self._track_client(client, item.future)
        runner = self._runner_for(req)
        try:
            runner.queue.put_nowait(item)
        except queue.Full:
            self.count("queue_full_503")
            raise QueueFull(
                f"admission queue for env {req.env!r} is full "
                f"({self.max_queue} requests); retry later",
                retry_after_s=runner.retry_after_estimate())
        runner.note_arrival(req.num_samples)
        self.count("submitted")
        return item.future

    def request(self, req: SampleRequest, *,
                deadline_s: Optional[float] = None,
                client: Optional[str] = None) -> SampleResult:
        """Submit and block until the request terminates.  Every path out
        of here is a result or a typed :class:`ServeError` — the wait is
        bounded by the deadline (plus scheduling grace) or, for
        deadline-less requests, by ``hard_timeout_s``."""
        fut = self.submit(req, deadline_s=deadline_s, client=client)
        deadline_rel = deadline_s if deadline_s is not None \
            else (req.deadline_s if req.deadline_s is not None
                  else self.default_deadline_s)
        wait = (self.hard_timeout_s if deadline_rel is None
                else float(deadline_rel) + 30.0)
        try:
            return fut.result(timeout=wait)
        except FutureTimeout:
            self.count("front_stalls")
            raise EngineFailure(
                f"front stalled: no response within {wait:.0f}s "
                "(runner wedged?)") from None

    # -- observability -------------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        with self._lock:
            runners = list(self._runners.values())
            draining = self._draining
        return {"status": "draining" if draining else "ok",
                "engines": sum(r.engine is not None for r in runners),
                "runners": len(runners),
                "dead_runners": sum(r.dead for r in runners),
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            runners = list(self._runners.items())
            draining = self._draining
        return {"uptime_s": round(time.monotonic() - self._t0, 3),
                "draining": draining,
                "counters": counters,
                "engines": [r.stats() for _, r in runners]}

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Stop the front.  ``drain=True`` (the SIGTERM path) stops
        admitting, lets runners finish their in-flight lanes and flush
        every response, then joins them; ``drain=False`` fails everything
        immediately with 503 ``shutting_down``.  Returns a drain report."""
        with self._lock:
            self._draining = True
            runners = list(self._runners.values())
        for r in runners:
            (r.stop_after_drain if drain else r.stop_now).set()
        clean = True
        for r in runners:
            r.join(timeout=timeout)
            clean = clean and not r.is_alive()
        return {"drained": drain and clean,
                "runners_joined": sum(not r.is_alive() for r in runners),
                "runners": len(runners)}
