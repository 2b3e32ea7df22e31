"""AMP reward (port of ``repro.rewards.amp``; paper §3.5 / §B.2.2): an
antimicrobial-peptide proxy classifier, R(x) = max(sigmoid(f(x)), r_min).

f is the JAX package's seeded transformer classifier (3 layers, 8 heads,
dim 64; masked mean pool, one logit).  Its weights are taken as params, by
default the seed-0 draw carried across from JAX
(:mod:`repro_torch.rewards.proxies`), with the positional table JAX draws
at this ``max_len``; a length the file does not hold raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..envs.base import SeqTerminal
from ..nn.core import dense_apply, embedding_apply
from ..nn.transformer import encoder_apply
from .proxies import AMP_LENGTHS, WRITER, as_tensors, load_proxy


class AMPRewardModule:

    def __init__(self, max_len: int = 60, vocab: int = 20,
                 r_min: float = 1e-4, seed: int = 0, num_heads: int = 8,
                 proxy: Optional[Dict[str, Any]] = None):
        self.max_len, self.vocab = max_len, vocab
        self.r_min = float(r_min)
        self.seed = int(seed)
        self.num_heads = num_heads
        self.proxy = proxy

    def init(self, device: torch.device) -> Dict[str, Any]:
        if self.proxy is not None:
            proxy = as_tensors(self.proxy, device)
        elif self.max_len not in AMP_LENGTHS:
            raise ValueError(
                f"JAX draws the AMP proxy's positional table for each "
                f"max_len; the carried-across file holds max_len "
                f"{AMP_LENGTHS} (written by `{WRITER}`), got {self.max_len}")
        else:
            proxy = load_proxy("amp", self.seed, device)
            if self.max_len != AMP_LENGTHS[0]:
                proxy["pos"] = load_proxy(f"amp_len{self.max_len}",
                                          self.seed, device)["pos"]
        rows = proxy["pos"]["pos"].shape[0]
        if rows != self.max_len:
            raise ValueError(f"the AMP proxy has {rows} positions, "
                             f"max_len is {self.max_len}")
        return {**proxy, "r_min": torch.tensor(self.r_min,
                                                dtype=torch.float32,
                                                device=device)}

    def classifier_logit(self, tokens: torch.Tensor, length: torch.Tensor,
                         params: Dict[str, Any]) -> torch.Tensor:
        S = tokens.shape[-1]
        mask = (torch.arange(S, device=tokens.device)[None]
                < length[:, None])
        x = (embedding_apply(params["embed"],
                             tokens.long().clamp(0, self.vocab))
             + params["pos"]["pos"][None, :S])
        h = encoder_apply(params["encoder"], x, num_heads=self.num_heads,
                          mask=mask)
        pooled = (torch.where(mask[..., None], h, 0.0).sum(1)
                  / torch.clamp(mask.sum(1, keepdim=True), min=1))
        return dense_apply(params["head"], pooled)[..., 0]

    def log_reward(self, terminal: SeqTerminal,
                   params: Dict[str, Any]) -> torch.Tensor:
        p = torch.sigmoid(self.classifier_logit(terminal.tokens,
                                                terminal.length, params))
        return torch.log(torch.maximum(p, params["r_min"]))
