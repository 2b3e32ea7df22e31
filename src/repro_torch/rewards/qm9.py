"""QM9 reward (port of ``repro.rewards.qm9``; paper §3.4): a proxy of the
HOMO-LUMO gap of a 5-block molecule built from 11 building blocks.

The proxy is the JAX package's seeded MLP (55 -> 64 -> 64 -> 1, tanh) over
the one-hot block sequence, squashed into (0.05, 1); R(x) = proxy(x) **
beta, beta = 10 (paper Table 4).  Its weights are taken as params, by
default the seed-0 draw carried across from JAX
(:mod:`repro_torch.rewards.proxies`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..envs.base import SeqTerminal, tokens_of_flat_index
from ..nn.core import mlp_apply
from .proxies import as_tensors, load_proxy


class QM9RewardModule:

    def __init__(self, beta: float = 10.0, seed: int = 0, length: int = 5,
                 vocab: int = 11, proxy: Optional[Dict[str, Any]] = None):
        self.beta = float(beta)
        self.seed = int(seed)
        self.length, self.vocab = length, vocab
        self.proxy = proxy

    def init(self, device: torch.device) -> Dict[str, Any]:
        proxy = (load_proxy("qm9", self.seed, device) if self.proxy is None
                 else as_tensors(self.proxy, device))
        return {"proxy": proxy,
                "beta": torch.tensor(self.beta, dtype=torch.float32,
                                     device=device)}

    def proxy_score(self, tokens: torch.Tensor,
                    params: Dict[str, Any]) -> torch.Tensor:
        x = F.one_hot(tokens.long().clamp(0, self.vocab - 1),
                      self.vocab).to(torch.float32)
        x = x.reshape(x.shape[:-2] + (self.length * self.vocab,))
        out = mlp_apply(params["proxy"], x, activation=torch.tanh)[..., 0]
        return 0.05 + 0.95 * torch.sigmoid(2.0 * out)

    def log_reward(self, terminal: SeqTerminal,
                   params: Dict[str, Any]) -> torch.Tensor:
        return params["beta"] * torch.log(
            self.proxy_score(terminal.tokens, params))

    def true_log_rewards(self, params: Dict[str, Any]) -> torch.Tensor:
        """log R over all 11^5 = 161,051 sequences, flat base-11 order."""
        n = self.vocab ** self.length
        idx = torch.arange(n, device=params["beta"].device)
        return params["beta"] * torch.log(self.proxy_score(
            tokens_of_flat_index(idx, self.vocab, self.length), params))

