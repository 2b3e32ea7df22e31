"""Hypergrid reward modules (port of ``repro.rewards.hypergrid``; paper
Eq. 8).

R(s) = R0 + R1 * prod_i I[0.25 < |s_i/(H-1) - 0.5|]
          + R2 * prod_i I[0.3  < |s_i/(H-1) - 0.5| < 0.4]

with the standard (R0, R1, R2) = (1e-3, 0.5, 2.0) of Bengio et al. 2021;
``EasyHypergridRewardModule`` is the flatter R0 = 0.1 variant.  The grid
coordinate is divided by ``side - 1`` in float32, as the JAX package does,
so the band tests give the same booleans bit for bit.
"""
from __future__ import annotations

from typing import Dict

import torch


class HypergridRewardModule:
    def __init__(self, r0: float = 1e-3, r1: float = 0.5, r2: float = 2.0):
        self.r0, self.r1, self.r2 = r0, r1, r2

    def init(self, device: torch.device, side: int
             ) -> Dict[str, torch.Tensor]:
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return {"r0": f32(self.r0), "r1": f32(self.r1), "r2": f32(self.r2),
                "side": f32(side)}

    def log_reward(self, pos: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) log R of (B, d) grid coordinates."""
        x = torch.abs(pos.to(torch.float32) / (params["side"] - 1) - 0.5)
        t1 = torch.all(x > 0.25, dim=-1).to(torch.float32)
        t2 = torch.all((x > 0.3) & (x < 0.4), dim=-1).to(torch.float32)
        return torch.log(params["r0"] + params["r1"] * t1
                         + params["r2"] * t2)


class EasyHypergridRewardModule(HypergridRewardModule):
    def __init__(self):
        super().__init__(r0=1e-1, r1=0.5, r2=2.0)
