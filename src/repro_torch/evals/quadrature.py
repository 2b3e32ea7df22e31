"""Quadrature-grid evaluator of continuous envs (port of
``repro.evals.quadrature``): the continuous analogue of the exact-DP
terminal-distribution metrics.

The terminal space is binned into a fixed ``G x G`` grid; the target cell
probabilities are the midpoint rule of the reward (``softmax`` of log R at
the cell centres: the area factor is uniform and cancels), built once on
the device; sampled terminal positions are binned the same way, and TV and
JSD compare the two.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.rollout import forward_rollout
from ..metrics.distributions import (empirical_distribution, jensen_shannon,
                                     total_variation)


class QuadratureDistributionEval:
    """``quad_tv`` / ``quad_jsd`` between the terminals of
    ``num_samples`` non-exploring rollouts and the quadrature-binned
    reward.  The env is a :class:`repro_torch.envs.box.BoxEnvironment`
    (terminal positions first in the observation); the policy a flow
    policy.  The rollouts draw from the forward rollout's default flow
    noise, keyed on the seed the suite passes."""

    metric_names: Tuple[str, ...] = ("quad_tv", "quad_jsd")

    def __init__(self, env, env_params, policy, grid_size: int,
                 num_samples: int):
        self.env, self.env_params, self.policy = env, env_params, policy
        self.grid_size = int(grid_size)
        self.num_samples = int(num_samples)
        self.target = self._target_distribution()

    def _target_distribution(self) -> torch.Tensor:
        """Normalised midpoint-rule reward mass per cell, flat C-order
        (``ix * G + iy``), on the env params' device."""
        from ..envs.box import BoxState
        G = self.grid_size
        dev = self.env_params.device
        centers = (torch.arange(G, dtype=torch.float32, device=dev) + 0.5) \
            / torch.tensor(float(G), device=dev)
        xx, yy = torch.meshgrid(centers, centers, indexing="ij")
        pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
        n = pos.shape[0]
        state = BoxState(pos=pos,
                         terminal=torch.ones(n, dtype=torch.bool, device=dev),
                         steps=torch.full((n,), 2, dtype=torch.int32,
                                          device=dev))
        return torch.softmax(self.env.log_reward(state, self.env_params), 0)

    def flat_index(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 2) positions in [0, 1]^2 -> (B,) flat cell indices; the
        cast truncates toward zero, as JAX's ``astype(int32)``."""
        G = self.grid_size
        ij = torch.clamp((pos * G).to(torch.int32), 0, G - 1)
        return ij[:, 0] * G + ij[:, 1]

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        batch = forward_rollout(seed, self.env, self.env_params, self.policy,
                                self.num_samples)
        pos = batch.obs[-1][:, :2]   # every rollout exits within max_steps
        emp = empirical_distribution(self.flat_index(pos),
                                     self.grid_size ** 2)
        return {"quad_tv": total_variation(emp, self.target),
                "quad_jsd": jensen_shannon(emp, self.target)}
