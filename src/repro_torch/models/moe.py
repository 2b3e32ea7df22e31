"""Mixture-of-Experts block of the LM tier (port of ``repro.models.moe``):
a top-k router and GShard dispatch with a capacity.

qwen2-moe: 60 routed experts padded to 64 (the pad experts get -inf router
logits and so no token) and 4 shared experts fused into one always-on
gated MLP of 4x width behind a sigmoid gate.  qwen3-moe: 128 routed
experts, top-8, no shared experts.

Tokens are routed in groups of ``group_size`` (``cfg.moe_group_size``,
512): each expert takes at most ``C = max(int(k * Tg / E *
capacity_factor), 1)`` (token, slot) pairs of a group of ``Tg`` tokens,
token-major (a token's k slots in rank order, then the next token's), and
drops the rest, which then reach the output only through the shared
experts and the residual.  The reference builds one-hot dispatch and
combine tensors (G, Tg, E, C) and contracts them with einsums; here the
same routing is an index table: each expert's C slots of each group gather
their token's row (an empty slot reads zeros, as a zero row of the
dispatch tensor gives), and each kept (token, slot) pair gathers its
expert's output back, weighted by its gate.  The gather reproduces the
dispatch einsum exactly (one nonzero term per slot), the combine to float
rounding (a batched product of each token's k gates, in the model's
dtype as the reference casts its combine tensor, with its k outputs).
Every expert runs over its C slots of every group, as in the reference:
a decode step reads every expert's weights.  The expert GEMMs are
batched over the experts on each layer's (E, d, f) leaf as it lies, with
no transposed copy.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..nn.core import Params
from .layers import gated_mlp


def padded_num_experts(cfg) -> int:
    """The expert count padded to a multiple of 16 (qwen2-moe: 60 -> 64)."""
    return cfg.padded_experts


def moe_block_init(cfg, attn: Params, init, dtype: torch.dtype,
                   device) -> Params:
    """All ``num_layers`` MoE blocks, stacked, with JAX's names: ``ln1``,
    ``attn`` (the stacked attention leaves given), ``ln2``, the router (L,
    d, E) in float32 whatever the model's dtype, the experts ``we_gate`` /
    ``we_up`` (L, E, d, moe_d_ff) and ``we_down`` (L, E, moe_d_ff, d), and
    with shared experts ``shared`` (a gated MLP of ``shared_d_ff``) and its
    gate ``shared_gate`` (L, d, 1).  ``init(*shape, dtype=...)`` draws a
    stacked leaf a layer at a time."""
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.moe_d_ff
    E = padded_num_experts(cfg)
    ones = lambda: {"scale": torch.ones(L, d, dtype=dtype, device=device)}
    p = {"ln1": ones(), "attn": attn, "ln2": ones(),
         "router": init(d, E, dtype=torch.float32),
         "we_gate": init(E, d, ff), "we_up": init(E, d, ff),
         "we_down": init(E, ff, d)}
    if cfg.shared_d_ff:
        sf = cfg.shared_d_ff
        p["shared"] = {"wi_gate": init(d, sf), "wi_up": init(d, sf),
                       "wo": init(sf, d)}
        p["shared_gate"] = init(d, 1)
    return p


def _router_probs(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """(T, E_padded) float32 softmax router probabilities; the pad experts'
    logits are -inf."""
    logits = x.to(torch.float32) @ p["router"]
    if padded_num_experts(cfg) != cfg.num_experts:
        logits[:, cfg.num_experts:] = float("-inf")
    return torch.softmax(logits, dim=-1)


def moe_route(p: Params, x: torch.Tensor, cfg,
              group_size: int) -> Dict[str, Any]:
    """The routing of ``x`` (T, d): the Switch-style load-balancing aux loss
    (float32 scalar), each token's top-k experts ``experts`` (T, k; ties to
    the lower index, as ``jax.lax.top_k``) and renormalized ``gates`` (T,
    k) float32, each (token, slot)'s position in its expert's queue
    ``position`` (T, k) and whether it fits the capacity ``keep`` (T, k),
    and ``groups``, ``group_tokens``, ``capacity``.  Raises ValueError when
    T is not a multiple of min(group_size, T): the reference's reshape
    into groups fails there."""
    T = x.shape[0]
    k = cfg.num_experts_per_tok
    E = padded_num_experts(cfg)
    Tg = min(group_size, T)
    if T % Tg:
        raise ValueError(f"moe: {T} tokens do not split into groups of "
                         f"{Tg} (the reference's reshape to (T // Tg, Tg) "
                         "fails there)")
    G = T // Tg
    C = max(int(k * Tg / E * cfg.capacity_factor), 1)
    probs = _router_probs(p, x, cfg)                          # (T, E)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]          # (T, k)
    me = probs.mean(0)
    # each expert's share of the k T pairs (counted by index_add_: CUDA's
    # bincount reads its input's max on the host)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, experts.reshape(-1), probs.new_ones(T * k)) / T / k
    aux = cfg.router_aux_loss * E * torch.sum(me * ce)
    gates = torch.gather(probs, 1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # each (token, slot)'s place in its expert's queue within its group,
    # token-major: the pairs of the group before it that chose that expert.
    # A stable sort by (group, expert) keeps the pairs of each queue in
    # token-major order; a pair's place is its rank from its queue's first
    # (the reference's cumsum over one-hot (G, Tg k, E), without the E-wide
    # tensor)
    queue = (torch.arange(T, device=x.device)[:, None] // Tg * E
             + experts).reshape(-1)
    order = torch.sort(queue, stable=True).indices
    ranked = queue[order]
    first = torch.searchsorted(ranked, ranked)
    position = torch.empty_like(order)
    position[order] = torch.arange(T * k, device=x.device) - first
    position = position.reshape(T, k)
    return {"aux": aux, "experts": experts, "gates": gates,
            "position": position, "keep": position < C, "groups": G,
            "group_tokens": Tg, "capacity": C}


def moe_mlp(p: Params, x: torch.Tensor, cfg,
            group_size: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed-expert MLP over x (B, S, d); returns (out, aux loss)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = moe_route(p, xt, cfg, group_size)
    E, G, Tg, C = (padded_num_experts(cfg), r["groups"], r["group_tokens"],
                   r["capacity"])
    T, k = r["experts"].shape
    dev = x.device
    token = torch.arange(T, device=dev)
    group = (token // Tg)[:, None].expand(T, k)
    # slot (e, g, c) of the experts' (E, G * C) rows; a dropped pair points
    # at the zero row past the end
    slot = torch.where(r["keep"], (r["experts"] * G + group) * C
                       + r["position"], E * G * C)
    # dispatch: each slot's token row (the zero row past the tokens when
    # the slot stays empty)
    src = torch.full((E * G * C + 1,), T, dtype=torch.int64, device=dev)
    src[slot.reshape(-1)] = token[:, None].expand(T, k).reshape(-1)
    rows = torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]]
    xe = rows.reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
    eo = torch.bmm(h, p["we_down"]).reshape(E * G * C, d)
    # combine: each kept pair's expert output times its gate (in the
    # model's dtype, as the reference casts its combine tensor), summed
    # over the k slots
    picked = torch.cat([eo, eo.new_zeros(1, d)])[slot]        # (T, k, d)
    w = r["gates"].to(x.dtype)[:, None, :]                    # (T, 1, k)
    out = torch.bmm(w, picked).reshape(B, S, d)
    if "shared" in p:
        shared = gated_mlp(p["shared"], x)
        sg = torch.sigmoid((x @ p["shared_gate"]).to(torch.float32))
        out = out + shared * sg.to(x.dtype)
    return out, r["aux"]


def moe_block_apply(p, x, cfg, positions, attention_sublayer, rmsnorm_fn,
                    cache=None, cache_index=None, window: int = 0,
                    group_size: int = 0):
    """Pre-norm attention (``attention_sublayer``), then the routed MLP,
    each added to the residual.  Returns (x, cache, aux loss); the
    backbone sums the layers' aux losses into the objective."""
    group_size = group_size or cfg.moe_group_size
    a, new_cache = attention_sublayer(p["attn"], rmsnorm_fn(p["ln1"], x),
                                      cfg, positions, cache, cache_index,
                                      window)
    x = x + a
    m, aux = moe_mlp(p, rmsnorm_fn(p["ln2"], x), cfg, group_size)
    return x + m, new_cache, aux
