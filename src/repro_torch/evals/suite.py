"""Evaluation suite (port of ``repro.evals.suite.EvalSuite``, host-side).

A bundle of evaluators run every ``every`` iterations: at each iteration
``it`` with ``it % every == 0``, after that iteration's update, as the JAX
package's python-mode hook records them.  Evaluators are read-only: they
read the policy's parameters in place and draw their noise from
:func:`repro_torch.core.types.eval_seed` of (suite seed, ``it``, evaluator
index), a stream disjoint from every training iteration's, so a run with
evals trains bit for bit as one without them.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, Tuple

import torch

from ..core.types import eval_seed


class Evaluator(Protocol):
    """One metric family: ``__call__(seed) -> {name: 0-dim tensor}`` with
    exactly the names of ``metric_names``."""
    metric_names: Tuple[str, ...]

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        ...


class EvalSuite:
    """Evaluators run every ``every`` iterations; :meth:`rows` gives the
    JAX package's row schema, ``[{"step": it, name: value, ...}]``."""

    def __init__(self, evaluators: Sequence[Evaluator], every: int = 1000,
                 seed: int = 0):
        if every <= 0:
            raise ValueError(f"every must be positive, got {every}")
        self.evaluators = tuple(evaluators)
        self.every, self.seed = int(every), int(seed)
        names: List[str] = []
        for ev in self.evaluators:
            for n in ev.metric_names:
                if n in names:
                    raise ValueError(f"duplicate metric name {n!r} across "
                                     "evaluators")
                names.append(n)
        self.metric_names: Tuple[str, ...] = tuple(names)
        self._rows: List[Dict[str, float]] = []

    def run(self, iteration: int) -> Dict[str, float]:
        """Run every evaluator once at ``iteration``; returns the row."""
        row: Dict[str, float] = {"step": int(iteration)}
        with torch.no_grad():
            for i, ev in enumerate(self.evaluators):
                out = ev(eval_seed(self.seed, iteration, i))
                for n in ev.metric_names:
                    row[n] = float(out[n])
        return row

    def maybe_record(self, iteration: int):
        """Record a row at the configured interval; returns it, or None."""
        if iteration % self.every:
            return None
        row = self.run(iteration)
        self._rows.append(row)
        return row

    def rows(self) -> List[Dict[str, float]]:
        return list(self._rows)
