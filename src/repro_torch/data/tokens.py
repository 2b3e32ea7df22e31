"""Synthetic token data (port of ``repro.data.tokens``).

A batch is keyed by (seed, step): ``np.random.RandomState((seed *
1_000_003 + step) % (2**31 - 1))`` draws it on the host exactly as the JAX
package does, so every tensor is bitwise JAX's, and a restarted run
regenerates any step's batch.  The GFlowNet log-reward is the reference's
cheap synthetic preference over token statistics.  Tensors are made on the
caller's device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig


def synthetic_gfn_batch(cfg: ModelConfig, batch: int, seq: int, *,
                        seed: int, step: int,
                        device=None) -> Dict[str, torch.Tensor]:
    """``tokens`` / ``targets`` (B, S) int32 (targets the tokens rolled one
    left), ``mask`` (B, S) float32 with the last position 0, ``log_reward``
    (B,) float32; the VLM gets ``embeds`` (B, S, d) bf16 and
    ``position_ids`` (3, B, S) int32 in place of ``tokens``, Whisper
    ``frames`` (B, S, d) bf16 besides."""
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31 - 1))
    tokens = rng.randint(0, cfg.vocab_size, size=(batch, seq),
                         dtype=np.int64).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mask = np.ones((batch, seq), np.float32)
    mask[:, -1] = 0.0
    log_reward = (np.cos(tokens.astype(np.float64) * 0.001).mean(1)
                  * 10.0).astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out: Dict[str, torch.Tensor] = {"tokens": put(tokens),
                                    "targets": put(targets),
                                    "mask": put(mask),
                                    "log_reward": put(log_reward)}
    if cfg.family == "vlm":
        embeds = rng.randn(batch, seq, cfg.d_model).astype(np.float32)
        out["embeds"] = put(embeds).to(torch.bfloat16)
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, batch, seq))
        out["position_ids"] = put(pos.astype(np.int32))
        del out["tokens"]
    if cfg.family == "encdec":
        frames = rng.randn(batch, seq, cfg.d_model).astype(np.float32)
        out["frames"] = put(frames).to(torch.bfloat16)
    return out


def token_stream(cfg: ModelConfig, batch: int, seq: int, *, seed: int,
                 start_step: int = 0, device=None
                 ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Infinite deterministic ``(step, batch)`` iterator (one batch made
    ahead, as JAX's)."""
    step = start_step
    nxt = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=step,
                              device=device)
    while True:
        cur = nxt
        nxt = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=step + 1,
                                  device=device)
        yield step, cur
        step += 1
