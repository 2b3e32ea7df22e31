"""TFBind8 reward (port of ``repro.rewards.tfbind8``; paper §3.3).

The JAX package replaces the measured SIX6 binding table with a seeded
surrogate over all 4^8 = 65,536 sequences: a mixture of Hamming-ball
bumps around random motifs plus a noise floor, scaled into (0, 1].  It is
drawn with numpy's ``RandomState``, so the port builds the same table bit
for bit.  R(x) = activity(x) ** beta, beta = 10 (paper Table 4).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..envs.base import SeqTerminal, flat_index_of_tokens


def synth_binding_table(seed: int = 0, length: int = 8, vocab: int = 4,
                        num_motifs: int = 12) -> np.ndarray:
    """The surrogate activity of every sequence, flat base-``vocab``
    order, in (0, 1] (float64, as the JAX package builds it)."""
    rng = np.random.RandomState(seed)
    n = vocab ** length
    seqs = np.stack(np.unravel_index(
        np.arange(n), (vocab,) * length), axis=-1).astype(np.int32)
    motifs = rng.randint(0, vocab, size=(num_motifs, length))
    weights = rng.uniform(0.3, 1.0, size=num_motifs)
    scales = rng.uniform(0.8, 2.0, size=num_motifs)
    score = np.zeros(n)
    for m, w, s in zip(motifs, weights, scales):
        d = (seqs != m[None]).sum(-1)
        score += w * np.exp(-d / s)
    score += 0.02 * rng.rand(n)              # measurement-noise floor
    score = (score - score.min()) / (score.max() - score.min())
    return 0.001 + 0.999 * score


class TFBind8RewardModule:
    """log R(x) = beta * log table[x] over length-8 sequences of 4
    symbols."""

    def __init__(self, beta: float = 10.0, seed: int = 0):
        self.beta = float(beta)
        self.seed = int(seed)

    def init(self, device: torch.device) -> Dict[str, torch.Tensor]:
        table = synth_binding_table(self.seed)
        return {"table": torch.as_tensor(table, dtype=torch.float32,
                                         device=device),
                "beta": torch.tensor(self.beta, dtype=torch.float32,
                                     device=device)}

    def log_reward(self, terminal: SeqTerminal,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        idx = flat_index_of_tokens(terminal.tokens.clamp(0, 3), 4, 8)
        return params["beta"] * torch.log(params["table"][idx])

    def true_log_rewards(self, params: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """log R over all 65,536 sequences, flat base-4 order."""
        return params["beta"] * torch.log(params["table"])
