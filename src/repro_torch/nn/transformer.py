"""The transformer layers of the port (port of ``repro.nn.transformer``):
the bidirectional pre-LayerNorm encoder (the pooled policy, the AMP proxy)
and the latent-query decoder with a stacked K/V cache (the decode arch).

The encoder is plain attention: the JAX package runs it outside any
kernel, and so does the port.

In the latent-query decoder each layer computes K/V from a token's frozen input embedding (token +
position) alone, and a learned latent query ``q0`` evolves through the
layer stack and cross-attends to the cache.  Appending one token's K/V is
therefore exact whatever the insertion order, and the cached pass and the
full pass over a bank of embeddings are the same math.

Cache layout, as in the JAX package: one stacked pair ``{"k", "v"}`` shaped
``(num_layers, B, capacity, H, hd)``.  Slot 0 holds the learned BOS entry;
a query attends slots ``0..lengths[b]``.  K is columns ``[:D]`` of a layer's
``kv`` projection and V columns ``[D:]``.  Unlike the JAX package, which is
functional, :func:`cache_append` writes into the cache tensors in place and
returns the same dict.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..kernels.ops import decode_attention
from .core import (Params, dense_apply, dense_init, gelu, layernorm_apply,
                   layernorm_init, normal_init)

Cache = Dict[str, torch.Tensor]


def encoder_init(*, num_layers: int, dim: int, num_heads: int,
                 generator: torch.Generator,
                 device: torch.device) -> Dict[str, Any]:
    """Per layer: ``ln1``, ``qkv`` (D -> 3D), ``proj``, ``ln2``, ``ff1``,
    ``ff2`` (MLP width 4 * dim); then ``ln_f``."""
    kw = dict(generator=generator, device=device)
    layers: Dict[str, Any] = {}
    for i in range(num_layers):
        layers[f"layer_{i}"] = {
            "ln1": layernorm_init(dim, device),
            "qkv": dense_init(dim, 3 * dim, **kw),
            "proj": dense_init(dim, dim, **kw),
            "ln2": layernorm_init(dim, device),
            "ff1": dense_init(dim, 4 * dim, **kw),
            "ff2": dense_init(4 * dim, dim, **kw),
        }
    layers["ln_f"] = layernorm_init(dim, device)
    return layers


def positional_embedding_init(max_len: int, dim: int, *,
                              generator: torch.Generator,
                              device: torch.device) -> Dict[str, Any]:
    return {"pos": normal_init((max_len, dim), std=0.02,
                               generator=generator, device=device)}


def _mha(p: Params, x: torch.Tensor, num_heads: int,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Self-attention over x (B, S, D); ``mask`` (B, S) marks the keys
    that may be attended.  Masked logits become ``finfo.min``, not
    ``-inf``, as in the JAX package (a row with no valid key is uniform,
    not NaN)."""
    B, S, D = x.shape
    hd = D // num_heads
    qkv = dense_apply(p["qkv"], x).reshape(B, S, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.finfo(logits.dtype).min)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D)
    return dense_apply(p["proj"], out)


def encoder_apply(p: Params, x: torch.Tensor, *, num_heads: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional pre-LayerNorm encoder over x (B, S, D); ``mask``
    (B, S), True = a valid key.  GELU is JAX's tanh approximation."""
    for i in range(num_layers_of(p)):
        lp = p[f"layer_{i}"]
        x = x + _mha(lp, layernorm_apply(lp["ln1"], x), num_heads, mask)
        h = layernorm_apply(lp["ln2"], x)
        x = x + dense_apply(lp["ff2"], gelu(dense_apply(lp["ff1"], h)))
    return layernorm_apply(p["ln_f"], x)


def decode_encoder_init(*, num_layers: int, dim: int, num_heads: int,
                        generator: torch.Generator,
                        device: torch.device) -> Dict[str, Any]:
    """Per layer: ``ln1``, ``q``, ``kv``, ``proj``, ``ln2``, ``ff1``, ``ff2``
    (MLP width 4 * dim); then ``ln_f`` and the latent query ``q0``."""
    kw = dict(generator=generator, device=device)
    layers: Dict[str, Any] = {}
    for i in range(num_layers):
        layers[f"layer_{i}"] = {
            "ln1": layernorm_init(dim, device),
            "q": dense_init(dim, dim, **kw),
            "kv": dense_init(dim, 2 * dim, **kw),
            "proj": dense_init(dim, dim, **kw),
            "ln2": layernorm_init(dim, device),
            "ff1": dense_init(dim, 4 * dim, **kw),
            "ff2": dense_init(4 * dim, dim, **kw),
        }
    layers["ln_f"] = layernorm_init(dim, device)
    layers["q0"] = normal_init((dim,), std=0.02, **kw)
    return layers


def num_layers_of(p: Params) -> int:
    return sum(1 for k in p if k.startswith("layer_"))


def _kv_heads(lp: Params, x: torch.Tensor, num_heads: int):
    """K/V of token embeddings x (..., D) -> two (..., H, hd) tensors."""
    D = x.shape[-1]
    kv = dense_apply(lp["kv"], x).reshape(
        x.shape[:-1] + (2, num_heads, D // num_heads))
    return kv[..., 0, :, :], kv[..., 1, :, :]


def _kv_heads_stacked(p: Params, x: torch.Tensor, num_heads: int):
    """All layers' K/V of x (..., D) -> two (num_layers, ..., H, hd)."""
    ks, vs = zip(*(_kv_heads(p[f"layer_{i}"], x, num_heads)
                   for i in range(num_layers_of(p))))
    return torch.stack(ks), torch.stack(vs)


def _single_query_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, H, hd); valid: (B, S) bool."""
    hd = q.shape[-1]
    logits = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(hd)
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", attn, v)


def cache_init(p: Params, x0: torch.Tensor, capacity: int, *,
               num_heads: int) -> Cache:
    """Zeroed stacked cache with the BOS entry ``x0`` (B, D) at slot 0."""
    B, D = x0.shape
    k0, v0 = _kv_heads_stacked(p, x0, num_heads)        # (Lyr, B, H, hd)
    shape = (num_layers_of(p), B, capacity, num_heads, D // num_heads)
    k = torch.zeros(shape, dtype=x0.dtype, device=x0.device)
    v = torch.zeros(shape, dtype=x0.dtype, device=x0.device)
    k[:, :, 0] = k0
    v[:, :, 0] = v0
    return {"k": k, "v": v}


def cache_append(p: Params, cache: Cache, x_new: torch.Tensor,
                 slot: Union[int, torch.Tensor], *, num_heads: int) -> Cache:
    """Write one token's K/V for every layer at ``slot``, in place.

    ``slot`` is a scalar shared by the batch (lockstep rollouts) or a (B,)
    tensor of per-row slots (the serving engine's lanes)."""
    kn, vn = _kv_heads_stacked(p, x_new, num_heads)     # (Lyr, B, H, hd)
    slot = torch.as_tensor(slot, device=x_new.device)
    if slot.dim() == 1:
        rows = torch.arange(slot.shape[0], device=x_new.device)
        cache["k"][:, rows, slot] = kn
        cache["v"][:, rows, slot] = vn
    else:
        cache["k"][:, :, int(slot)] = kn
        cache["v"][:, :, int(slot)] = vn
    return cache


def _decode_query(p: Params, num_heads: int,
                  kv_of_layer: Callable[[int], Any],
                  attend: Callable, batch: int, dim: int) -> torch.Tensor:
    """The latent query through the layer stack, then ``ln_f``."""
    hd = dim // num_heads
    h = p["q0"][None, :].expand(batch, dim)
    for i in range(num_layers_of(p)):
        lp = p[f"layer_{i}"]
        k, v = kv_of_layer(i)
        qh = dense_apply(lp["q"], layernorm_apply(lp["ln1"], h))
        o = attend(qh.reshape(batch, num_heads, hd), k, v)
        h = h + dense_apply(lp["proj"], o.reshape(batch, dim))
        g = layernorm_apply(lp["ln2"], h)
        h = h + dense_apply(lp["ff2"], gelu(dense_apply(lp["ff1"], g)))
    return layernorm_apply(p["ln_f"], h)


def encoder_query_cached(p: Params, cache: Cache, lengths: torch.Tensor, *,
                         num_heads: int) -> torch.Tensor:
    """Latent-query pass over the cache, slots ``0..lengths[b]`` attended.
    Returns (B, D).

    On a CUDA cache each layer's attention is the decode-attention kernel
    (``kernels.ops.decode_attention`` with ``kv_valid = lengths + 1``, the
    BOS slot included) over the contiguous layer views ``cache["k"][i]``;
    like the kernel, this path is forward only.  On the CPU it is the plain
    masked softmax.  (The fully fused step is ``kernels.ops.decode_step``,
    one level up.)"""
    k_all = cache["k"]
    B, C = k_all.shape[1], k_all.shape[2]
    dim = k_all.shape[3] * k_all.shape[4]
    if k_all.device.type == "cuda":
        kv_valid = lengths.to(torch.int32) + 1
        attend = lambda q, k, v: decode_attention(q, k, v, kv_valid)
    else:
        valid = (torch.arange(C, device=lengths.device)[None, :]
                 <= lengths[:, None])
        attend = lambda q, k, v: _single_query_attention(q, k, v, valid)
    return _decode_query(
        p, num_heads, lambda i: (cache["k"][i], cache["v"][i]), attend, B,
        dim)


def encoder_apply_cached(p: Params, x_new: torch.Tensor, cache: Cache,
                         lengths: torch.Tensor, *, num_heads: int,
                         slot: Union[int, torch.Tensor]):
    """Append ``x_new``'s K/V at ``slot``, then query.  Returns
    ``(y (B, D), cache)``."""
    cache = cache_append(p, cache, x_new, slot, num_heads=num_heads)
    return encoder_query_cached(p, cache, lengths,
                                num_heads=num_heads), cache


def decoder_stacked_weights(p: Params) -> Dict[str, torch.Tensor]:
    """Per-layer weights stacked into contiguous ``(num_layers, ...)``
    tensors, the operand layout of the fused decode-step kernel."""
    L = num_layers_of(p)

    def stack(get):
        return torch.stack([get(p[f"layer_{i}"]) for i in range(L)]
                           ).contiguous()

    return {
        "ln1_scale": stack(lambda lp: lp["ln1"]["scale"]),
        "ln1_bias": stack(lambda lp: lp["ln1"]["bias"]),
        "q_w": stack(lambda lp: lp["q"]["w"]),
        "q_b": stack(lambda lp: lp["q"]["b"]),
        "kv_w": stack(lambda lp: lp["kv"]["w"]),
        "kv_b": stack(lambda lp: lp["kv"]["b"]),
        "proj_w": stack(lambda lp: lp["proj"]["w"]),
        "proj_b": stack(lambda lp: lp["proj"]["b"]),
        "ln2_scale": stack(lambda lp: lp["ln2"]["scale"]),
        "ln2_bias": stack(lambda lp: lp["ln2"]["bias"]),
        "ff1_w": stack(lambda lp: lp["ff1"]["w"]),
        "ff1_b": stack(lambda lp: lp["ff1"]["b"]),
        "ff2_w": stack(lambda lp: lp["ff2"]["w"]),
        "ff2_b": stack(lambda lp: lp["ff2"]["b"]),
        "ln_f_scale": p["ln_f"]["scale"].detach().contiguous(),
        "ln_f_bias": p["ln_f"]["bias"].detach().contiguous(),
        "q0": p["q0"].detach().contiguous(),
    }


def encoder_apply_bank(p: Params, xs: torch.Tensor, mask: torch.Tensor, *,
                       num_heads: int) -> torch.Tensor:
    """Full (uncached) latent-query pass over a bank of embeddings.

    xs: (B, S, D) with BOS included by the caller; mask: (B, S) True =
    attendable.  Same math as the cached path, in one batch."""
    B, S, D = xs.shape
    return _decode_query(
        p, num_heads, lambda i: _kv_heads(p[f"layer_{i}"], xs, num_heads),
        lambda q, k, v: _single_query_attention(q, k, v, mask), B, D)
