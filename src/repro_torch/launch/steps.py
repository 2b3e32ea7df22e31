"""Serve and prefill steps of the LM tier (port of
``repro.launch.steps``).

``make_serve_step``: one KV-cache decode step (greedy next token and the
logits), or ``cfg.decode_steps`` of them fused into one call; the VLM
takes its embeddings and M-RoPE ids as ``extra``.  ``make_prefill_step``:
full-prompt scoring (per-token target log-probs through
``forward_train``).  Both take ``params = {"model":
<LM params>, ...}`` as in JAX and run without autograd.  Train steps,
optimizers and sharding come with LM training (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ..models import lm as LM
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """``step(params, tokens (B, 1), cache, extra=None) -> (next_tok (B,)
    int32, logits (B, V) float32, cache)``; the cache is updated in place.
    ``extra`` holds the VLM's ``embeds`` (B, 1, d) and ``position_ids``
    (3, B, 1), which it reads in place of the tokens; the other families
    take no extras (JAX ignores them there) and refuse any.  With
    ``cfg.decode_steps`` > 1 a call takes that many greedy steps, each fed
    the token the one before chose and the same ``extra``, and returns the
    last token and the last logits; ``cache["index"]`` advances by
    ``decode_steps`` (JAX's ``lax.scan`` of the one-step function, a
    Python loop here).  So the VLM's fused steps all read the same
    embeddings and position ids while the index advances, as JAX's do
    (``ROADMAP.md``, queue 3, reference item 13)."""

    @torch.no_grad()
    def one(params, tokens, cache, extra: Optional[Mapping[str, Any]] = None):
        extra = dict(extra or {})
        if cfg.family != "vlm" and extra:
            raise ValueError(f"serve step extras {sorted(extra)} are the "
                             f"VLM's; the {cfg.family} family takes none")
        logits, cache = LM.decode_step(
            params["model"], cfg, tokens, cache, embeds=extra.get("embeds"),
            position_ids=extra.get("position_ids"))
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    if cfg.decode_steps <= 1:
        return one

    def serve_step(params, tokens, cache,
                   extra: Optional[Mapping[str, Any]] = None):
        for _ in range(cfg.decode_steps):
            next_tok, logits, cache = one(params, tokens, cache, extra)
            tokens = next_tok[:, None]
        return next_tok, logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """``step(params, batch) -> (B, S) float32`` per-token log-probs of
    ``batch["targets"]`` given ``batch["tokens"]`` (the VLM: ``embeds`` and
    ``position_ids``; Whisper: ``frames`` too), as ``forward_train``."""

    @torch.no_grad()
    def prefill_step(params, batch):
        lp, _ = LM.forward_train(params["model"], cfg, batch)
        return lp

    return prefill_step
