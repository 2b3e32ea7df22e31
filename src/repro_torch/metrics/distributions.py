"""Distribution-quality metrics (port of the part of
``repro.metrics.distributions`` the hypergrid evals use): the empirical
terminal distribution, total variation and Jensen-Shannon divergence
against the target R(x)/Z.
"""
from __future__ import annotations

from typing import Optional

import torch


def empirical_distribution(flat_indices: torch.Tensor, num_states: int,
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Histogram of terminal-state indices as a distribution (num_states,).

    Out-of-range indices are dropped.  A batch with no in-range weight gives
    the uniform distribution (a proper distribution, so TV and JSD against
    it stay finite), not zeros."""
    w = torch.ones(flat_indices.shape, dtype=torch.float32,
                   device=flat_indices.device) if weights is None \
        else weights.to(torch.float32)
    in_range = (flat_indices >= 0) & (flat_indices < num_states)
    counts = torch.zeros(num_states, dtype=torch.float32,
                         device=flat_indices.device)
    counts.index_add_(0, flat_indices.long().clamp(0, num_states - 1),
                      torch.where(in_range, w, 0.0))
    total = counts.sum()
    uniform = torch.full_like(counts, 1.0 / num_states)
    return torch.where(total > 0, counts / torch.clamp(total, min=1e-9),
                       uniform)


def total_variation(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """TV(p, q) = 0.5 * sum |p - q| (paper Figs. 2 and 4)."""
    return 0.5 * torch.abs(p - q).sum()


def jensen_shannon(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """JSD (paper Eq. 15), natural log."""
    m = 0.5 * (p + q)

    def kl(a, b):
        ratio = torch.where(a > 0, a / torch.clamp(b, min=1e-38), 1.0)
        return torch.where(a > 0, a * torch.log(ratio), 0.0).sum()

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)
