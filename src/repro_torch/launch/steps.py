"""Train, serve and prefill steps of the LM tier (port of
``repro.launch.steps``).

``make_train_step``: the GFlowNet-TB fine-tuning step (the paper's Eq. 4
with the degenerate P_B of autoregressive token MDPs: ``L = (log Z + sum
log p_theta - log R)^2``) or plain CE pretraining, with JAX's AdamW chain
(global-norm clip, Adam with b2 = 0.95, decay, the log Z group's learning
rate) and the MoE load-balancing aux loss added to the objective.
``make_serve_step``: one KV-cache decode step (greedy next token and the
logits), or ``cfg.decode_steps`` of them fused into one call; the VLM
takes its embeddings and M-RoPE ids as ``extra``.  ``make_prefill_step``:
full-prompt scoring (per-token target log-probs through
``forward_train``).  The steps take ``params = {"model": <LM params>,
"log_z": <0-dim float32>}`` as in JAX; serve and prefill run without
autograd.  One process, one device: JAX's sharding (the mesh, ZeRO-3
states, int8 gradient compression) waits for ``ROADMAP.md``'s item 21.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models import lm as LM
from ..models.config import ModelConfig
from ..optim import adamw as optim


class LMTrainConfig(NamedTuple):
    objective: str = "tb"        # tb | ce
    lr: float = 3e-5
    log_z_lr: float = 1e-2
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    grad_compression: Optional[str] = None   # None | "int8_ef" (pod axis)


def make_optimizer(tcfg: LMTrainConfig) -> optim.Transform:
    """JAX's chain: clip by global norm, Adam (0.9, 0.95), decoupled decay,
    the log Z group at ``log_z_lr / lr`` of the rest, then ``-lr``.
    ``grad_compression="int8_ef"`` (the cross-pod wire format) raises: it
    needs the sharding of ``ROADMAP.md``'s item 21."""
    if tcfg.grad_compression == "int8_ef":
        raise NotImplementedError(
            "grad_compression='int8_ef' compresses the cross-pod all-reduce; "
            "the port trains on one card until sharding lands (ROADMAP.md, "
            "queue 1 item 21)")
    if tcfg.grad_compression is not None:
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")
    lz_ratio = tcfg.log_z_lr / tcfg.lr
    return optim.chain(
        optim.clip_by_global_norm(tcfg.max_grad_norm),
        optim.scale_by_adam(b1=0.9, b2=0.95),
        optim.add_decayed_weights(tcfg.weight_decay),
        optim.scale_by_label(
            lambda name: "log_z" if "log_z" in name else "default",
            {"log_z": lz_ratio, "default": 1.0}),
        optim.scale(-tcfg.lr))


def init_lm_params(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None) -> Dict[str, Any]:
    """``{"model": LM params (a ParamTree whose leaves require grad),
    "log_z": 0-dim float32 zero}`` (JAX's ``init_lm_params``; the model's
    values come from ``generator``, not JAX's key)."""
    model = LM.init_params(cfg, generator=generator, device=device)
    model.requires_grad_(True)
    dev = next(model.parameters()).device
    return {"model": model,
            "log_z": torch.zeros((), dtype=torch.float32, device=dev,
                                 requires_grad=True)}


def param_leaves(params) -> Dict[str, torch.Tensor]:
    """Every leaf of ``params`` by JAX's flattened name (``log_z``,
    ``model/layers/attn/wq``): the tensors themselves, in name order."""
    return dict(sorted(optim.state_leaves(params).items()))


def loss_fn(params, cfg: ModelConfig, tcfg: LMTrainConfig,
            batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, {"loss": objective, "aux": aux})``, float32 scalars:
    TB ``mean((log Z + sum_t mask lp - log R)^2)`` or CE ``-sum(mask lp) /
    max(sum(mask), 1)``, plus the MoE's aux loss (0 elsewhere)."""
    lp, aux = LM.forward_train(params["model"], cfg, batch)
    mask = batch.get("mask")
    lp = lp.to(torch.float32)
    if mask is not None:
        lp = lp * mask
    log_pf = torch.sum(lp, dim=-1)                     # (B,)
    if tcfg.objective == "tb":
        delta = params["log_z"] + log_pf - batch["log_reward"]
        obj = torch.mean(torch.square(delta))
    else:
        denom = torch.sum(mask) if mask is not None else \
            torch.tensor(float(lp.numel()), device=lp.device)
        obj = -torch.sum(lp) / torch.clamp(denom, min=1.0)
    total = obj + aux
    return total, {"loss": obj, "aux": aux}


def make_train_step(cfg: ModelConfig, tcfg: LMTrainConfig):
    """``(train_step, tx)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``.  The gradient of ``loss_fn``'s total
    with respect to every leaf (zeros for a leaf the pass does not reach,
    as JAX's), ``tx``'s update, and ``p + u.to(p.dtype)`` written into the
    parameters in place (so ``params`` is returned as it was given, its
    tensors updated); the metrics stay on the device."""
    tx = make_optimizer(tcfg)

    def train_step(params, opt_state, batch):
        leaves = param_leaves(params)
        total, metrics = loss_fn(params, cfg, tcfg, batch)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    materialize_grads=True)
        with torch.no_grad():
            updates, opt_state = tx.update(
                dict(zip(leaves, grads)), opt_state,
                {n: t.detach() for n, t in leaves.items()})
            optim.apply_updates_(leaves, updates)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


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
