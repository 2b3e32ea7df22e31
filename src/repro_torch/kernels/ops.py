"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

A wrapper checks its operands and dispatches on their device: a CUDA
tensor launches the hand-written kernel (or the call raises), a CPU tensor
runs the kernel's plain version from :mod:`repro_torch.kernels.ref`.  There
is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Union

import torch

from .ref import ref_decode_step

#: keys of the stacked decoder weights the fused step takes
DECODE_STEP_WEIGHTS = (
    "ln1_scale", "ln1_bias", "q_w", "q_b", "kv_w", "kv_b", "proj_w",
    "proj_b", "ln2_scale", "ln2_bias", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
    "ln_f_scale", "ln_f_bias", "q0")


def _check(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"decode_step: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"decode_step: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"decode_step: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_step: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_step: {name} must be contiguous")


def decode_step(w: Mapping[str, torch.Tensor], x_new: torch.Tensor,
                cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                slot: Union[int, torch.Tensor], gumbel: torch.Tensor,
                action_mask: torch.Tensor, w_out: torch.Tensor,
                b_out: torch.Tensor,
                logit_temp: Optional[torch.Tensor] = None, *,
                num_heads: int):
    """Fused cached-rollout step: cache append + latent-query decode +
    masked Gumbel-max sampling, one kernel program per row.

    ``cache`` is the stacked pair ``{"k", "v"}`` of (num_layers, B, C, H, hd)
    float32 tensors; the new token's K/V is written into it **in place**
    (on either device) and the same dict is returned.  ``lengths`` is (B,)
    int32 (slots ``0..lengths[b]`` are attended); ``slot`` a scalar or (B,)
    int32 append slot in ``[0, C)``; ``gumbel`` (B, A) float32 noise;
    ``action_mask`` (B, A) bool; ``w_out``/``b_out`` (D, A)/(A,) the
    forward-logit readout; ``logit_temp`` an optional (B,) float32 scale.
    Every tensor must be contiguous and on ``x_new``'s device.
    Returns ``(action (B,) int32, log_pf (B,), y (B, D), cache)``.
    """
    dev = x_new.device
    f32 = torch.float32
    L, B, C, H, hd = cache["k"].shape
    D = H * hd
    if H != num_heads:
        raise ValueError(f"decode_step: cache has {H} heads, "
                         f"num_heads={num_heads}")
    F = w["ff1_w"].shape[-1]
    A = action_mask.shape[-1]
    _check("x_new", x_new, (B, D), f32, dev)
    _check("cache['k']", cache["k"], (L, B, C, H, hd), f32, dev)
    _check("cache['v']", cache["v"], (L, B, C, H, hd), f32, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    if not isinstance(slot, torch.Tensor):
        slot = torch.full((B,), int(slot), dtype=torch.int32, device=dev)
    elif slot.dim() == 0:
        slot = slot.to(torch.int32).expand(B).contiguous()
    _check("slot", slot, (B,), torch.int32, dev)
    _check("gumbel", gumbel, (B, A), f32, dev)
    _check("action_mask", action_mask, (B, A), torch.bool, dev)
    _check("w_out", w_out, (D, A), f32, dev)
    _check("b_out", b_out, (A,), f32, dev)
    if logit_temp is not None:
        _check("logit_temp", logit_temp, (B,), f32, dev)
    shapes = {"ln1_scale": (L, D), "ln1_bias": (L, D), "q_w": (L, D, D),
              "q_b": (L, D), "kv_w": (L, D, 2 * D), "kv_b": (L, 2 * D),
              "proj_w": (L, D, D), "proj_b": (L, D), "ln2_scale": (L, D),
              "ln2_bias": (L, D), "ff1_w": (L, D, F), "ff1_b": (L, F),
              "ff2_w": (L, F, D), "ff2_b": (L, D), "ln_f_scale": (D,),
              "ln_f_bias": (D,), "q0": (D,)}
    for k in DECODE_STEP_WEIGHTS:
        _check(f"w[{k!r}]", w[k], shapes[k], f32, dev)

    if dev.type == "cpu":
        action, log_pf, y, nk, nv = ref_decode_step(
            w, x_new, cache["k"].view(L, B, C, D),
            cache["v"].view(L, B, C, D), lengths, slot, gumbel, action_mask,
            w_out, b_out, logit_temp, num_heads=num_heads)
        cache["k"].view(L, B, C, D).copy_(nk)
        cache["v"].view(L, B, C, D).copy_(nv)
        return action, log_pf, y, cache
    if dev.type != "cuda":
        raise ValueError(f"decode_step: no kernel for device {dev}")

    from . import build
    action = torch.empty(B, dtype=torch.int32, device=dev)
    log_pf = torch.empty(B, dtype=f32, device=dev)
    y = torch.empty(B, D, dtype=f32, device=dev)
    ptrs = {"x_new": x_new, "k_cache": cache["k"], "v_cache": cache["v"],
            "lengths": lengths, "slot": slot, "logit_temp": logit_temp,
            "gumbel": gumbel, "mask": action_mask, "w_out": w_out,
            "b_out": b_out, "action": action, "log_pf": log_pf, "y": y,
            **{k: w[k] for k in DECODE_STEP_WEIGHTS}}
    args = build.DecodeStepArgs(
        **{k: (None if ptrs[k] is None else ptrs[k].data_ptr())
           for k in build.DECODE_STEP_PTRS},
        num_layers=L, batch=B, capacity=C, dim=D, num_heads=H, ff_dim=F,
        num_actions=A, device=dev.index if dev.index is not None
        else torch.cuda.current_device())
    err = build.library().repro_decode_step(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step kernel launch failed: CUDA error "
                           f"{err}")
    decode_step.launches += 1
    return action, log_pf, y, cache


decode_step.launches = 0
