"""Sampling evaluator (port of ``repro.evals.sampling.
SampledDistributionEval``): empirical TV/JSD of on-policy samples against
a target, and the number of distinct modes the sample hits.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.rollout import forward_rollout
from ..metrics.distributions import (empirical_distribution, jensen_shannon,
                                     total_variation)


class SampledDistributionEval:
    """On-policy rollout histogram against a target: ``sample_tv`` /
    ``sample_jsd`` when ``true_dist`` is given, ``mode_hits`` (distinct
    modes in the sample) when ``mode_indices`` is.

    ``index_fn(batch) -> (B,)`` maps a rollout batch to flat terminal-state
    indices in the target's order.  ``noise`` is the rollout's noise source
    (default: the forward rollout's own)."""

    def __init__(self, env, env_params, policy, index_fn: Callable,
                 num_states: int,
                 true_dist: Optional[torch.Tensor] = None,
                 mode_indices: Optional[torch.Tensor] = None,
                 num_samples: int = 2000, noise=None):
        self.env, self.env_params, self.policy = env, env_params, policy
        self.index_fn = index_fn
        self.num_states = int(num_states)
        self.true = true_dist
        self.mode_indices = (None if mode_indices is None
                             else mode_indices.long())
        self.num_samples = int(num_samples)
        self.noise = noise
        names: Tuple[str, ...] = ()
        if true_dist is not None:
            names += ("sample_tv", "sample_jsd")
        if mode_indices is not None:
            names += ("mode_hits",)
        if not names:
            raise ValueError("need true_dist and/or mode_indices")
        self.metric_names = names

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        batch = forward_rollout(seed, self.env, self.env_params, self.policy,
                                self.num_samples, noise=self.noise)
        idx = self.index_fn(batch)
        out: Dict[str, torch.Tensor] = {}
        if self.true is not None:
            emp = empirical_distribution(idx, self.num_states)
            out["sample_tv"] = total_variation(emp, self.true)
            out["sample_jsd"] = jensen_shannon(emp, self.true)
        if self.mode_indices is not None:
            hits = (idx[None, :] == self.mode_indices[:, None]).any(1)
            out["mode_hits"] = hits.sum().to(torch.float32)
        return out
