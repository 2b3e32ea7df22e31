"""Deterministic fault injection for the serving stack (port of
``repro.serve.faults``; a given plan fires on the same occurrences as the
JAX package's).

A :class:`FaultPlan` is a seedable schedule of failures threaded through
the serving hot path so tests (and ``scripts/serve_chaos_torch.py``) can
*prove* every failure mode maps to a typed :mod:`repro_torch.serve.errors`
error — never a hung client, never a poisoned lane pool.  Injection points:

``engine_step``   raise :class:`InjectedFault` from inside
                  :meth:`SamplingEngine.step` — a transient (or, if fired
                  repeatedly, persistent) lane-block failure; exercises
                  retry-with-backoff and quarantine-and-rebuild.
``latency``       sleep ``latency_s`` before a lane block — an
                  artificial latency spike; exercises deadlines (504) and
                  admission-queue backpressure (503).
``lane_state``    overwrite the accumulated log-reward of every occupied
                  lane with NaN — malformed device state; exercises
                  drain-time validation (:class:`LanePoisoned`) and replay.
``restore``       raise :class:`InjectedFault` from engine construction
                  (the checkpoint-restore path); exercises typed build
                  failures and rebuild-on-next-request.

Determinism: firing is a pure function of ``(seed, point, occurrence
index)`` — each point keeps its own occurrence counter, and probabilistic
specs draw from a ``random.Random`` seeded per (plan seed, point).  Two
plans built with the same specs and seed fire identically, so chaos runs
are replayable.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

#: the injection points a FaultSpec may target
POINTS = ("engine_step", "latency", "lane_state", "restore")


class InjectedFault(RuntimeError):
    """The exception a firing ``engine_step``/``restore`` fault raises."""

    def __init__(self, point: str, occurrence: int, detail: str = ""):
        super().__init__(f"injected fault at {point!r} "
                         f"(occurrence {occurrence})"
                         + (f": {detail}" if detail else ""))
        self.point = point
        self.occurrence = occurrence


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault schedule: fire at explicit occurrence indices (``at``)
    and/or with probability ``rate`` per occurrence (seeded, deterministic).

    point       injection point (one of :data:`POINTS`)
    at          0-based occurrence indices that always fire
    rate        per-occurrence firing probability (0.0 = never)
    latency_s   sleep duration for ``latency`` faults
    detail      free-form tag carried into the raised error
    """
    point: str
    at: Tuple[int, ...] = ()
    rate: float = 0.0
    latency_s: float = 0.05
    detail: str = ""

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {POINTS}")


class FaultPlan:
    """A deterministic, seedable schedule of :class:`FaultSpec`\\ s.

    Thread-safe: occurrence counters are lock-guarded because engine-runner
    threads for different engine keys may consult one shared plan.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._counts: Dict[str, int] = {p: 0 for p in POINTS}
        self._fired: Dict[str, int] = {p: 0 for p in POINTS}
        self._rng: Dict[str, random.Random] = {
            p: random.Random(zlib.crc32(p.encode()) ^ self.seed)
            for p in POINTS}
        self._lock = threading.Lock()

    @classmethod
    def single(cls, point: str, *, at: Tuple[int, ...] = (0,),
               latency_s: float = 0.05, seed: int = 0) -> "FaultPlan":
        """One fault at explicit occurrences of ``point`` — the common
        test-fixture shape."""
        return cls([FaultSpec(point=point, at=at, latency_s=latency_s)],
                   seed=seed)

    def fires(self, point: str) -> List[FaultSpec]:
        """Advance ``point``'s occurrence counter by one and return the
        specs that fire at this occurrence (usually 0 or 1)."""
        with self._lock:
            i = self._counts[point]
            self._counts[point] = i + 1
            out = []
            for spec in self.specs:
                if spec.point != point:
                    continue
                if i in spec.at or (spec.rate > 0.0 and
                                    self._rng[point].random() < spec.rate):
                    out.append(spec)
            if out:
                self._fired[point] += 1
            return out

    def occurrence(self, point: str) -> int:
        """How many times ``point`` has been consulted so far."""
        with self._lock:
            return self._counts[point]

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {p: {"consulted": self._counts[p], "fired": self._fired[p]}
                    for p in POINTS}

    def maybe_raise(self, point: str) -> None:
        """Raise :class:`InjectedFault` if a spec fires at this occurrence
        of ``point`` (used by the ``engine_step``/``restore`` points)."""
        fired = self.fires(point)
        if fired:
            raise InjectedFault(point, self.occurrence(point) - 1,
                                fired[0].detail)
