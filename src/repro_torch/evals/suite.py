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

    # -- checkpoints: JAX's MetricsState layout --------------------------------
    def num_rows(self, num_iterations: int) -> int:
        """Rows a run records: one at every ``it % every == 0`` in
        ``[0, num_iterations)``."""
        if num_iterations <= 0:
            return 0
        return (num_iterations - 1) // self.every + 1

    def metrics_state(self, num_iterations: int) -> Dict[str, torch.Tensor]:
        """The recorded rows as JAX's ``MetricsState`` leaves, by flattened
        name under ``.metrics``: ``.steps`` (R,) int32 (-1 unfilled),
        ``.values/<name>`` (R,) float32 (NaN unfilled) and ``.count``,
        R = :meth:`num_rows`."""
        R = self.num_rows(num_iterations)
        rows = self._rows[:R]
        steps = torch.full((R,), -1, dtype=torch.int32)
        steps[:len(rows)] = torch.tensor([r["step"] for r in rows],
                                         dtype=torch.int32)
        out = {".metrics/.steps": steps}
        for n in self.metric_names:
            v = torch.full((R,), float("nan"), dtype=torch.float32)
            v[:len(rows)] = torch.tensor([r[n] for r in rows],
                                         dtype=torch.float32)
            out[f".metrics/.values/{n}"] = v
        out[".metrics/.count"] = torch.tensor(len(rows), dtype=torch.int32)
        return out

    def load_metrics_state(self, data: Dict[str, torch.Tensor],
                           num_iterations: int) -> None:
        """Take the rows of a checkpoint's ``.metrics`` leaves (the inverse
        of :meth:`metrics_state`), keeping at most :meth:`num_rows` of them
        (JAX's ``_migrate_metrics``: a resume with another iteration
        budget resizes the row buffer)."""
        names = [".metrics/.steps", ".metrics/.count"] + [
            f".metrics/.values/{n}" for n in self.metric_names]
        missing = [n for n in names if n not in data]
        if missing:
            raise ValueError(f"checkpoint has no entry for {missing[0]!r}: "
                             "it was saved without this eval suite")
        count = min(int(data[".metrics/.count"]),
                    self.num_rows(num_iterations))
        steps = data[".metrics/.steps"]
        self._rows = [
            dict({"step": int(steps[r])},
                 **{n: float(data[f".metrics/.values/{n}"][r])
                    for n in self.metric_names})
            for r in range(count)]
