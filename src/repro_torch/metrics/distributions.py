"""Distribution-quality metrics (port of ``repro.metrics.distributions``):
the empirical terminal distribution, total variation and Jensen-Shannon
divergence against the target R(x)/Z, Pearson and (tie-correct) Spearman
correlations, the Monte-Carlo estimate of log P_theta(x) over backward
rollouts, and AMP's top-k reward and diversity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def pearson_correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x - x.mean()
    y = y - y.mean()
    denom = torch.sqrt((x * x).sum() * (y * y).sum()) + 1e-12
    return (x * y).sum() / denom


def average_ranks(x: torch.Tensor) -> torch.Tensor:
    """Fractional (average) ranks, 1-based: tied values share the mean of
    the positions they occupy (``scipy.stats.rankdata(method='average')``).
    The sort is stable, as ``jnp.argsort``."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    xs = x[order]
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                         xs[1:] != xs[:-1]])
    run_id = torch.cumsum(new_run, 0) - 1
    pos = torch.arange(n, dtype=torch.float32, device=x.device)
    run_sum = torch.zeros(n, dtype=torch.float32,
                          device=x.device).index_add_(0, run_id, pos)
    run_cnt = torch.zeros(n, dtype=torch.float32, device=x.device
                          ).index_add_(0, run_id, torch.ones_like(pos))
    ranks_sorted = run_sum[run_id] / torch.clamp(run_cnt[run_id],
                                                 min=1.0) + 1.0
    return torch.zeros(n, dtype=torch.float32, device=x.device).scatter(
        0, order, ranks_sorted)


def spearman_correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman's rho: Pearson correlation of average ranks."""
    return pearson_correlation(average_ranks(x), average_ranks(y))


def _tile_state(state, n: int):
    """A state dataclass with every field repeated ``n`` times along the
    batch, sample-major (copy i is rows ``i * B .. (i + 1) * B``)."""
    return type(state)(**{
        f.name: getattr(state, f.name).repeat(
            (n,) + (1,) * (getattr(state, f.name).dim() - 1))
        for f in dataclasses.fields(state)})


def log_prob_mc_estimate(seed: int, env, env_params, policy, terminal_state,
                         num_samples: int = 10,
                         noise=None) -> torch.Tensor:
    """Monte-Carlo estimate of log P_theta(x) (paper §B.2) per terminal
    state, over ``num_samples`` trajectories from the backward policy:

        P_theta(x) = E_{P_B(tau|x)}[P_F(tau) / P_B(tau|x)]

    in log space.  The N rollouts run as one (N * B)-row backward rollout;
    sample i of row r draws ``noise(seed_i, r, t, Ab)``, with seed_i the
    i-th of :func:`repro_torch.core.types.sample_seeds` ``(seed, N)`` (the
    JAX package vmaps N rollouts over ``split(key, N)``)."""
    from ..core.rollout import backward_rollout
    from ..core.types import sample_seeds

    B = terminal_state.steps.shape[0]
    dev = terminal_state.steps.device
    seeds = torch.tensor(sample_seeds(seed, num_samples), dtype=torch.int64,
                         device=dev).repeat_interleave(B)
    index = torch.arange(B, dtype=torch.int64, device=dev).repeat(num_samples)
    out = backward_rollout(seeds, env, env_params, policy,
                           _tile_state(terminal_state, num_samples),
                           noise=noise, index=index)
    ratios = (out.log_pf - out.log_pb).reshape(num_samples, B)
    return torch.logsumexp(ratios, 0) - math.log(num_samples)


def topk_reward_and_diversity(rewards: torch.Tensor, objects: torch.Tensor,
                              k: int = 100
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k mean reward and the mean pairwise Hamming distance of the
    top-k objects (paper Fig. 5, AMP).  The top k are taken by a stable
    descending sort, as ``jnp.argsort(-rewards)``."""
    k = min(k, rewards.shape[0])
    idx = torch.argsort(-rewards, stable=True)[:k]
    top_x = objects[idx]
    ham = (top_x[:, None, :] != top_x[None, :, :]).to(torch.float32).sum(-1)
    off_diag = 1.0 - torch.eye(k, device=rewards.device)
    diversity = (ham * off_diag).sum() / torch.clamp(off_diag.sum(), min=1.0)
    return rewards[idx].mean(), diversity
