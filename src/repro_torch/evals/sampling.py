"""Sampling evaluators (port of ``repro.evals.sampling``): empirical
TV/JSD of on-policy samples against a target and the number of distinct
modes the sample hits; the correlation of the Monte-Carlo log P_theta(x)
with log R(x) over a fixed probe of terminal states; and the uniform
probe such a correlation reads.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.rollout import forward_rollout
from ..metrics.distributions import (empirical_distribution, jensen_shannon,
                                     log_prob_mc_estimate,
                                     pearson_correlation,
                                     spearman_correlation, total_variation)


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


class RewardCorrelationEval:
    """``pearson`` / ``spearman`` correlation of the Monte-Carlo estimate
    of log P_theta(x) (paper §B.2, over backward rollouts) with log R(x)
    over a fixed probe of terminal states (the paper's Fig. 3/6 metric).
    ``noise`` is the backward rollouts' noise source (default: their
    own)."""

    metric_names: Tuple[str, ...] = ("pearson", "spearman")

    def __init__(self, env, env_params, policy, probe_states,
                 probe_log_r: torch.Tensor, mc_samples: int = 8,
                 noise=None):
        self.env, self.env_params, self.policy = env, env_params, policy
        self.probe_states = probe_states
        self.probe_log_r = probe_log_r.to(torch.float32)
        self.mc_samples = int(mc_samples)
        self.noise = noise

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        lp = log_prob_mc_estimate(seed, self.env, self.env_params,
                                  self.policy, self.probe_states,
                                  num_samples=self.mc_samples,
                                  noise=self.noise)
        return {"pearson": pearson_correlation(lp, self.probe_log_r),
                "spearman": spearman_correlation(lp, self.probe_log_r)}


class _UniformPolicy:
    """Zero logits: the uniform policy over the legal actions."""

    def __init__(self, action_dim: int):
        self.action_dim = action_dim

    def apply(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"logits": torch.zeros(obs.shape[0], self.action_dim,
                                      device=obs.device)}


def uniform_probe_states(seed: int, env, env_params, num_probe: int,
                         stop_action: Optional[int] = None, noise=None):
    """Terminal states and their log-rewards from a uniform-policy rollout
    keyed on ``seed`` (a correlation probe needs the spread of log-rewards
    a uniform sampler gives).  With ``stop_action``, rows that ran out of
    steps before stopping take one final stop step, so every probe state
    is a genuine terminal.  The JAX package draws its probe from
    ``jax.random``; the port's comes from its own noise (``noise``,
    default the forward rollout's hash): equally distributed, not the
    same states."""
    _, final = forward_rollout(seed, env, env_params,
                               _UniformPolicy(env.action_dim), num_probe,
                               noise=noise, return_final_state=True)
    if stop_action is not None:
        stop = torch.full((num_probe,), int(stop_action), dtype=torch.int64,
                          device=final.steps.device)
        _, final, _, _ = env.step(final, stop, env_params)
    return final, env.log_reward(final, env_params)
