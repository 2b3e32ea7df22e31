"""Shared model layers of the LM tier (port of ``repro.models.layers``):
RMSNorm, the gated MLP, RoPE and M-RoPE, attention and the chunked linear
recurrence.

``flash_attention`` and ``chunked_linear_attention`` call the kernel
wrappers of :mod:`repro_torch.kernels.ops`, which launch the hand-written
CUDA kernels on a CUDA tensor and run their plain versions on a CPU tensor.
Dtypes follow the JAX layers: norms and the attention / scan internals in
float32, results in the input's dtype.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..nn.core import Params

# ---------------------------------------------------------------------------
# Norms / MLP
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def gated_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["wi_gate"])
    return (g * (x @ p["wi_up"])) @ p["wo"]


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the interleaved
    pairs (x[2i], x[2i+1]) by position / theta^(2i / D), in float32."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                      # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv        # (B, S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _mrope_bands(sections: Tuple[int, ...], half: int,
                 device: torch.device) -> torch.Tensor:
    """(half,) int64: the position component each frequency band reads.
    ``sections`` in order, the last one cut or run on to fill ``half``
    bands (JAX's ``jnp.repeat`` with ``total_repeat_length``)."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)]
    return torch.tensor((ids + ids[-1:] * half)[:half], device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): x (B, S, H, D), positions (3, B, S) for (t, h,
    w).  The D/2 frequency bands are split into ``sections``, each rotated
    by its own position component; the pairs are interleaved as in
    :func:`apply_rope`.  With t == h == w it is :func:`apply_rope`."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                      # (D/2,)
    pos = positions[_mrope_bands(tuple(sections), D // 2,
                                 positions.device)]           # (D/2, B, S)
    ang = pos.movedim(0, -1).to(torch.float32) * inv          # (B, S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention and the linear recurrence, through the kernels
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, window: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention with GQA head grouping: q (B, Sq, H, D); k, v
    (B, Skv, KVH, D).  ``q_offset`` is q[0]'s absolute position, ``window``
    the sliding window (0 = unlimited), ``kv_len`` the valid kv length.
    Runs :func:`repro_torch.kernels.ops.flash_attention`.  The JAX layer's
    ``chunk`` (its kv chunk, which changes only the float rounding) is not
    taken: the kernel streams the keys in tiles of its own."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len)


def chunked_linear_attention(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, w: torch.Tensor,
                             u: Optional[torch.Tensor] = None,
                             state: Optional[torch.Tensor] = None):
    """Linear attention with per-channel decay (the RWKV6 wkv form):
    ``S_t = diag(w_t) S_{t-1} + k_t^T v_t``, ``o_t = r_t S_{t-1} +
    (r_t . u . k_t) v_t``.  r/k/w: (B, T, H, Dk); v: (B, T, H, Dv); u:
    (H, Dk) or None; state: (B, H, Dk, Dv) or None.  Returns
    ``(o (B, T, H, Dv) in r's dtype, state_out float32)`` through
    :func:`repro_torch.kernels.ops.rwkv6_scan`, which computes the
    recurrence to float rounding on every route: on CUDA
    (``ops.scan_route``) bf16 over T >= 64 runs the chunk-parallel
    tensor-core kernel and the rest the step recurrence kernel; on the CPU
    the plain step recurrence.  The port's chunk form forms every decay
    factor as exp of a difference of log-cumsums that is <= 0, so it stays
    exact where the JAX layer's chunk form, which divides by the running
    product clamped at 1e-30, departs from the recurrence (a chunk whose
    decays multiply below 1e-30; ``ROADMAP.md``, queue 3).  The JAX layer's
    ``chunk`` argument is not taken: the kernel's chunk is 64 steps."""
    return ops.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                          w.contiguous(), u, state)
