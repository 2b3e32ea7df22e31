"""Box reward (port of ``repro.rewards.box``): a mixture of isotropic
Gaussians on the unit square plus a floor,

    R(x) = r0 + sum_k w_k N(x; mu_k, sigma^2 I),

with three equal modes inside the Box env's reachable staircase (at
trajectory depths of about 2, 3 and 4 increments) and a small floor r0.
Every numeric piece lives in the params dict, made on the device once, so
the reward is a function of ``(pos, params)`` with no host read.
"""
from __future__ import annotations

from typing import Dict

import torch

_LOG_2PI = 1.8378770664093453
#: the mixture's modes, its common sigma and the floor (JAX's defaults)
MEANS = ((0.32, 0.4), (0.6, 0.55), (0.82, 0.78))
SIGMA = 0.05
R0 = 0.03


def mixture_log_density(pos: torch.Tensor,
                        params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(..., 2) positions -> (...,) log of the mixture density (no floor),
    in the JAX package's order of float32 operations."""
    means = params["means"]                                  # (K, 2)
    sigma = torch.exp(params["log_sigma"])
    d2 = (pos[..., None, :] - means).square().sum(-1)        # (..., K)
    log_comp = (params["log_weights"] - d2 / (2.0 * sigma.square())
                - _LOG_2PI - 2.0 * params["log_sigma"])
    return torch.logsumexp(log_comp, dim=-1)


class BoxRewardModule:
    """Mixture-of-Gaussians plus floor over terminal positions."""

    @staticmethod
    def init(device: torch.device) -> Dict[str, torch.Tensor]:
        f32 = dict(dtype=torch.float32, device=device)
        w = torch.ones(len(MEANS), **f32)
        return {"means": torch.tensor(MEANS, **f32),
                "log_sigma": torch.log(torch.tensor(SIGMA, **f32)),
                "log_weights": torch.log(w / w.sum()),
                "r0": torch.tensor(R0, **f32)}

    @staticmethod
    def log_reward(pos: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) log R of (B, 2) terminal positions."""
        dens = torch.exp(mixture_log_density(pos, params))
        return torch.log(params["r0"] + dens)
