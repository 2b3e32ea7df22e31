"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

A wrapper checks its operands and dispatches on their device: a CUDA
tensor launches the hand-written kernel (or the call raises), a CPU tensor
runs the kernel's plain version from :mod:`repro_torch.kernels.ref`.  There
is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``, and the
launches a CUDA graph being captured recorded instead in
``<wrapper>.captured`` (:func:`captured_launches`): a replay runs them
again without Python, so no count moves then.

Under ``torch.func.vmap`` (a seed plan's stacked runs), ``decode_attention``,
``traj_logprob`` (forward and backward) and ``subtb_loss`` (forward and
backward) batch by a rule that folds the vmapped axis into the batch axis:
(S, B, ...) becomes (S*B, ...), the wrapper is called **once** (one kernel
launch on CUDA, the plain version on the CPU), and the result is cut back
to (S, B, ...).  Each produces one output row per input row, so the fold
needs no kernel change.  ``decode_step`` has no rule and raises there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Mapping, Optional, Union

import torch

from .ref import (ref_decode_attention, ref_decode_step,
                  ref_flash_attention, ref_flash_attention_bwd,
                  ref_flash_attention_lse, ref_rwkv6, ref_rwkv6_bwd,
                  ref_subtb, ref_subtb_backward, ref_traj_logprob,
                  ref_traj_logprob_backward)

#: keys of the stacked decoder weights the fused step takes
DECODE_STEP_WEIGHTS = (
    "ln1_scale", "ln1_bias", "q_w", "q_b", "kv_w", "kv_b", "proj_w",
    "proj_b", "ln2_scale", "ln2_bias", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
    "ln_f_scale", "ln_f_bias", "q0")


def _functorch_wrapped(*tensors) -> bool:
    """Whether any operand is a ``torch.func`` transform's wrapper (a
    vmapped or grad-tracked tensor)."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


class _Function(torch.autograd.Function):
    """An ``autograd.Function`` in the ``setup_context`` form, which
    ``torch.func`` transforms need for a ``vmap`` rule.  Torch's ``apply``
    binds a call of that form through ``inspect.signature`` every time;
    every ``forward`` here takes its operands positionally, with no
    defaults, so outside a transform the binding is skipped (the rest of
    torch's path is kept).  It cost 30-60 us a call on the card's host
    (``scripts/eager_wrappers_ab.py``)."""

    @classmethod
    def apply(cls, *args):
        if torch._C._are_functorch_transforms_active():
            return super().apply(*args)
        return super(torch.autograd.Function, cls).apply(
            *torch._functorch.utils.unwrap_dead_wrappers(args))


def _fold(batch_size: int, in_dims, args) -> list:
    """A batching rule's operands with the vmapped axis folded into the
    leading (batch) axis: an operand with the axis has it moved to the
    front, one without it is expanded, and (S, B, ...) becomes
    (S*B, ...).  The fold of an expanded operand is a copy, S times its
    size (a stride-0 axis cannot merge with the batch axis; the kernels
    take dense operands).  Non-tensors pass through."""
    out = []
    for a, d in zip(args, in_dims):
        if not isinstance(a, torch.Tensor):
            out.append(a)
            continue
        a = (a.expand(batch_size, *a.shape) if d is None
             else a.movedim(d, 0))
        out.append(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]))
    return out


def _unfold(batch_size: int, out):
    """Undo :func:`_fold` on a result (a tensor or a tuple of them):
    (S*B, ...) back to (S, B, ...), with the vmapped axis at 0."""
    if isinstance(out, tuple):
        return (tuple(_unfold(batch_size, o)[0] for o in out),
                (0,) * len(out))
    return out.view((batch_size, out.shape[0] // batch_size)
                    + out.shape[1:]), 0


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _require(name: str, op: str, t: torch.Tensor, dtype: torch.dtype,
             device: torch.device, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{op}: {name} has {t.dim()} dims, expected {ndim}")


def _refuse_grad(op: str, *tensors) -> None:
    """A forward-only kernel: with grad mode on, an operand that requires
    grad raises instead of silently cutting the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{op} has no gradient: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")


#: the counts' increments are read-modify-writes; the serving front
#: launches from a runner thread per engine
_COUNT_LOCK = threading.Lock()


def _launched(wrapper, route: Optional[str] = None) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``launches`` (and its
    route's count) when it ran, in ``captured`` when the stream was being
    captured into a CUDA graph, which recorded the launch."""
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            wrapper.captured += 1
        else:
            wrapper.launches += 1
            if route is not None:
                wrapper.route_launches[route] += 1


def captured_launches() -> Dict[str, int]:
    """Each wrapper's launches recorded into CUDA graphs so far, by kernel
    name; the difference across a capture is what one replay launches."""
    return {"decode_step": decode_step.captured,
            "decode_attention": decode_attention.captured,
            "traj_logprob_fwd": traj_logprob.captured,
            "traj_logprob_bwd": traj_logprob_backward.captured,
            "subtb_loss_fwd": subtb_loss.captured,
            "subtb_loss_bwd": subtb_loss_backward.captured,
            "flash_attention": flash_attention.captured,
            "flash_attention_bwd": flash_attention_backward.captured,
            "rwkv6_scan": rwkv6_scan.captured,
            "rwkv6_scan_bwd": rwkv6_scan_backward.captured}


def _check(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
           device: torch.device) -> None:
    """decode_step's operand check: exact shape, contiguous."""
    _require(name, "decode_step", t, dtype, device, len(shape))
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
    It has no batching rule: under ``torch.func.vmap`` (a seed axis) it
    raises.
    """
    if torch._C._are_functorch_transforms_active() and _functorch_wrapped(
            x_new, cache["k"], gumbel, *w.values()):
        raise RuntimeError(
            "decode_step has no batching rule: the fused step does not run "
            "under torch.func transforms (a seed plan's vmap); seed plans "
            "train through the exploring rollout, which never calls it")
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
        num_actions=A, device=_device_index(dev))
    err = build.library().repro_decode_step(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step kernel launch failed: CUDA error "
                           f"{err}")
    _launched(decode_step)
    return action, log_pf, y, cache


decode_step.launches = decode_step.captured = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: torch.Tensor) -> torch.Tensor:
    """Single-query decode attention against a KV cache (port of
    ``repro.kernels.ops.decode_attention``).

    q: (B, H, hd) float32; k/v: (B, S, H, hd) float32, contiguous (a layer
    of the stacked cache, ``cache["k"][i]``); kv_valid: (B,) int32 live
    leading slots.  Returns (B, H, hd); rows with ``kv_valid <= 0`` are
    exact zeros.  Forward only: with grad mode on, an operand that requires
    grad raises (the JAX package's ``decode_attention_grad`` waits for
    backward replay)."""
    op = "decode_attention"
    _refuse_grad(op, q, k, v)
    return _DecodeAttention.apply(q, k, v, kv_valid)


def _decode_attention(q, k, v, kv_valid):
    """:func:`decode_attention` on unwrapped operands: the checks, then
    the kernel or its plain version."""
    op = "decode_attention"
    dev = q.device
    f32 = torch.float32
    _require("q", op, q, f32, dev, 3)
    _require("k", op, k, f32, dev, 4)
    _require("v", op, v, f32, dev, 4)
    _require("kv_valid", op, kv_valid, torch.int32, dev, 1)
    B, H, hd = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, H, hd) or tuple(v.shape) != (B, S, H, hd) \
            or tuple(kv_valid.shape) != (B,):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_valid "
                         f"{tuple(kv_valid.shape)} do not agree")
    if dev.type == "cpu":
        return ref_decode_attention(q, k, v, kv_valid)
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    if hd > 64:
        raise ValueError(f"{op}: the kernel takes head dims up to 64, "
                         f"got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_valid", kv_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")

    from . import build
    out = torch.empty_like(q)
    args = build.DecodeAttentionArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        kv_valid=kv_valid.data_ptr(), out=out.data_ptr(), batch=B, slots=S,
        num_heads=H, head_dim=hd, device=_device_index(dev))
    err = build.library().repro_decode_attention(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    _launched(decode_attention)
    return out


decode_attention.launches = decode_attention.captured = 0


class _DecodeAttention(_Function):
    """:func:`decode_attention` with its batching rule (forward only)."""

    @staticmethod
    def forward(q, k, v, kv_valid):
        return _decode_attention(q, k, v, kv_valid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, kv_valid):
        S = info.batch_size
        return _unfold(S, _DecodeAttention.apply(
            *_fold(S, in_dims, (q, k, v, kv_valid))))


def _traj_operands(op: str, logits, actions, mask, valid) -> None:
    """Check the (B, T, A) / (B, T) operands.  Any (B, T) strides are
    taken; along A the stride must be 1 (checked before a launch)."""
    dev = logits.device
    _require("logits", op, logits, torch.float32, dev, 3)
    _require("actions", op, actions, torch.int64, dev, 2)
    _require("mask", op, mask, torch.bool, dev, 3)
    _require("valid", op, valid, torch.bool, dev, 2)
    B, T, A = logits.shape
    if tuple(mask.shape) != (B, T, A) or tuple(actions.shape) != (B, T) \
            or tuple(valid.shape) != (B, T):
        raise ValueError(f"{op}: shapes logits {tuple(logits.shape)}, "
                         f"actions {tuple(actions.shape)}, mask "
                         f"{tuple(mask.shape)}, valid {tuple(valid.shape)} "
                         "do not agree")


def _traj_args(logits, actions, mask, valid, **ptrs):
    from . import build
    B, T, A = logits.shape
    for name, t in (("logits", logits), ("mask", mask)):
        if A > 1 and t.stride(2) != 1:
            raise ValueError(f"traj_logprob: {name} needs unit stride along "
                             "the action axis")
    g_step = ptrs.get("g_step")
    return build.TrajLogprobArgs(
        logits=logits.data_ptr(), mask=mask.data_ptr(),
        actions=actions.data_ptr(), valid=valid.data_ptr(),
        **{k: (None if v is None else v.data_ptr())
           for k, v in ptrs.items()},
        logits_sb=logits.stride(0), logits_st=logits.stride(1),
        mask_sb=mask.stride(0), mask_st=mask.stride(1),
        actions_sb=actions.stride(0), actions_st=actions.stride(1),
        valid_sb=valid.stride(0), valid_st=valid.stride(1),
        g_step_sb=0 if g_step is None else g_step.stride(0),
        g_step_st=0 if g_step is None else g_step.stride(1),
        batch=B, steps=T, num_actions=A,
        device=_device_index(logits.device))


#: per-device int32 arrival counters of the forward kernel (zero between
#: launches: the kernel returns each to 0); grown to the largest batch
_TRAJ_ARRIVALS: Dict[torch.device, torch.Tensor] = {}
#: the buffers a larger batch replaced: a CUDA graph captured with one
#: launches on its pointer at every replay, so none is ever freed
_TRAJ_ARRIVALS_REPLACED: List[torch.Tensor] = []


def _traj_arrivals(dev: torch.device, batch: int) -> torch.Tensor:
    buf = _TRAJ_ARRIVALS.get(dev)
    if buf is None or buf.numel() < batch:
        if buf is not None:
            _TRAJ_ARRIVALS_REPLACED.append(buf)
        buf = torch.zeros(max(batch, 64), dtype=torch.int32, device=dev)
        _TRAJ_ARRIVALS[dev] = buf
    return buf


def _traj_forward(logits, actions, mask, valid):
    dev = logits.device
    if dev.type == "cpu":
        return ref_traj_logprob(logits, actions, mask, valid)
    if dev.type != "cuda":
        raise ValueError(f"traj_logprob: no kernel for device {dev}")
    from . import build
    B, T, _ = logits.shape
    total = torch.empty(B, dtype=torch.float32, device=dev)
    per_step = torch.empty(B, T, dtype=torch.float32, device=dev)
    args = _traj_args(logits, actions, mask, valid, total=total,
                      per_step=per_step,
                      arrivals=_traj_arrivals(dev, B))
    err = build.library().repro_traj_logprob_fwd(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"traj_logprob kernel launch failed: CUDA error "
                           f"{err}")
    _launched(traj_logprob)
    return total, per_step


def traj_logprob_backward(logits: torch.Tensor, actions: torch.Tensor,
                          mask: torch.Tensor, valid: torch.Tensor,
                          g_total: torch.Tensor,
                          g_step: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`traj_logprob` with respect to ``logits``:
    ``(g_total[b] + g_step[b, t]) * valid * (onehot(action) - softmax)``
    over the masked logits, (B, T, A) float32.  The backward kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    op = "traj_logprob_backward"
    _traj_operands(op, logits, actions, mask, valid)
    dev = logits.device
    B, T, A = logits.shape
    _require("g_total", op, g_total, torch.float32, dev, 1)
    _require("g_step", op, g_step, torch.float32, dev, 2)
    if tuple(g_total.shape) != (B,) or tuple(g_step.shape) != (B, T):
        raise ValueError(f"{op}: cotangents of shapes "
                         f"{tuple(g_total.shape)}, {tuple(g_step.shape)}")
    return _TrajLogprobBackward.apply(logits, actions, mask, valid, g_total,
                                      g_step)


def _traj_backward(logits, actions, mask, valid, g_total, g_step):
    """:func:`traj_logprob_backward` on unwrapped, checked operands."""
    op = "traj_logprob_backward"
    dev = logits.device
    B, T, A = logits.shape
    if dev.type == "cpu":
        return ref_traj_logprob_backward(logits, actions, mask, valid,
                                         g_total, g_step)
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    from . import build
    g_total = g_total.contiguous()
    dlogits = torch.empty(B, T, A, dtype=torch.float32, device=dev)
    args = _traj_args(logits, actions, mask, valid, g_total=g_total,
                      g_step=g_step, dlogits=dlogits)
    err = build.library().repro_traj_logprob_bwd(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    _launched(traj_logprob_backward)
    return dlogits


traj_logprob_backward.launches = traj_logprob_backward.captured = 0


class _TrajLogprobBackward(_Function):
    """The backward kernel with its batching rule (not differentiated
    again)."""

    @staticmethod
    def forward(logits, actions, mask, valid, g_total, g_step):
        return _traj_backward(logits, actions, mask, valid, g_total, g_step)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        S = info.batch_size
        return _unfold(S, _TrajLogprobBackward.apply(
            *_fold(S, in_dims, args)))


class _TrajLogprob(_Function):
    @staticmethod
    def forward(logits, actions, mask, valid):
        return _traj_forward(logits, actions, mask, valid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g_total, g_step):
        logits, actions, mask, valid = ctx.saved_tensors
        return (traj_logprob_backward(logits, actions, mask, valid, g_total,
                                      g_step), None, None, None)

    @staticmethod
    def vmap(info, in_dims, logits, actions, mask, valid):
        S = info.batch_size
        return _unfold(S, _TrajLogprob.apply(
            *_fold(S, in_dims, (logits, actions, mask, valid))))


def traj_logprob(logits: torch.Tensor, actions: torch.Tensor,
                 mask: torch.Tensor, valid: torch.Tensor):
    """Trajectory log-probabilities with a closed-form gradient (port of
    ``repro.kernels.ops.traj_logprob``).

    logits: (B, T, A) float32; actions: (B, T) int64; mask: (B, T, A) bool;
    valid: (B, T) bool.  Any (B, T) strides are taken (the training path
    passes transposed time-major views), but the action axis must have
    unit stride.  On CUDA the forward is one launch; its arrival counters
    are shared per device, so calls must not run on two streams at once.
    Returns ``(total (B,), per_step (B, T))``: mask +
    log-softmax + action gather, zero where ``valid`` is False, summed over
    t in order.  Gradients flow to ``logits`` only, through
    :func:`traj_logprob_backward`; when ``logits`` needs no grad the
    backward never runs."""
    _traj_operands("traj_logprob", logits, actions, mask, valid)
    return _TrajLogprob.apply(logits, actions, mask, valid)


traj_logprob.launches = traj_logprob.captured = 0


#: per-device count of SubTB calls whose lengths left [0, T], where the
#: check could not read the host (:func:`check_device_errors` reads it)
_SUBTB_LENGTH_ERRORS: Dict[torch.device, torch.Tensor] = {}


def device_error_counts(dev: torch.device) -> torch.Tensor:
    """The 0-dim int32 count of operand errors that wrappers found on
    ``dev`` where they could not read the host (a CUDA graph's capture,
    each of its replays, a capture's warm-up): such a check is a device op
    that adds here.  Made before a capture (``TrainLoop`` does so), so that the
    graph holds a buffer that outlives it."""
    if dev not in _SUBTB_LENGTH_ERRORS:
        _SUBTB_LENGTH_ERRORS[dev] = torch.zeros((), dtype=torch.int32,
                                                device=dev)
    return _SUBTB_LENGTH_ERRORS[dev]


def check_device_errors(dev: torch.device) -> None:
    """Raise if a SubTB call on ``dev`` that could not read its lengths on
    the host (:func:`_subtb_operands`) had lengths out of range since the
    last check (one host read), and clear the count."""
    errors = device_error_counts(dev)
    n = int(errors)
    if n:
        errors.zero_()
        raise ValueError(f"subtb_loss: lengths must lie in [0, T]; {n} "
                         "captured calls on the device had lengths outside")


def _subtb_operands(op: str, phi: torch.Tensor, length: torch.Tensor,
                    lam: float) -> torch.Tensor:
    """Check phi (B, T+1) float32, length (B,) integer on phi's device with
    0 <= length <= T, and 0 < lam <= 1; return length as int32.  The range
    check (:func:`_subtb_range`, made where the operands are unwrapped, so
    inside a batching rule on the folded lengths) reads the lengths on the
    host, except where a host read is
    forbidden: while the stream is being captured into a CUDA graph, and
    under ``torch.cuda.set_sync_debug_mode("error")`` (a capture's
    warm-up).  There it counts the bad calls in
    :func:`device_error_counts`, on the device (in a graph: at every
    replay), for :func:`check_device_errors` to raise on."""
    dev = phi.device
    _require("phi", op, phi, torch.float32, dev, 2)
    if not isinstance(length, torch.Tensor) or length.device != dev:
        raise ValueError(f"{op}: length must be a tensor on {dev}")
    if length.dtype not in (torch.int32, torch.int64) or length.dim() != 1:
        raise TypeError(f"{op}: length must be a 1-D int32 or int64 tensor, "
                        f"got {length.dtype} with {length.dim()} dims")
    B, T1 = phi.shape
    if tuple(length.shape) != (B,) or T1 < 1:
        raise ValueError(f"{op}: phi {tuple(phi.shape)} and length "
                         f"{tuple(length.shape)} do not agree")
    if not 0.0 < float(lam) <= 1.0:
        raise ValueError(f"{op}: lam must lie in (0, 1], got {lam}")
    return length.to(torch.int32)


def _subtb_range(op: str, phi: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """The lengths' range check of :func:`_subtb_operands`, on unwrapped
    operands (a batching rule's folded ones); returns them contiguous."""
    dev = phi.device
    B, T1 = phi.shape
    if B and dev.type == "cuda" and (
            torch.cuda.is_current_stream_capturing()
            or torch.cuda.get_sync_debug_mode() == 2):
        bad = ((length < 0) | (length > T1 - 1)).any()
        device_error_counts(dev).add_(bad.to(torch.int32))
    elif B:
        lo, hi = (int(v) for v in torch.aminmax(length))
        if lo < 0 or hi > T1 - 1:
            raise ValueError(f"{op}: lengths must lie in [0, {T1 - 1}], got "
                             f"[{lo}, {hi}]")
    return length.contiguous()


def _subtb_args(phi, length, lam, **ptrs):
    from . import build
    B, T1 = phi.shape
    return build.SubtbArgs(
        phi=phi.data_ptr(), length=length.data_ptr(),
        **{k: v.data_ptr() for k, v in ptrs.items()},
        phi_sb=phi.stride(0), phi_st=phi.stride(1), lam=float(lam),
        batch=B, states=T1, device=_device_index(phi.device))


def _subtb_forward(phi: torch.Tensor, length: torch.Tensor,
                   lam: float) -> torch.Tensor:
    length = _subtb_range("subtb_loss", phi, length)
    dev = phi.device
    if dev.type == "cpu":
        return ref_subtb(phi, length, lam)
    if dev.type != "cuda":
        raise ValueError(f"subtb_loss: no kernel for device {dev}")
    from . import build
    loss = torch.empty(phi.shape[0], dtype=torch.float32, device=dev)
    args = _subtb_args(phi, length, lam, loss=loss)
    err = build.library().repro_subtb_fwd(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subtb_loss kernel launch failed: CUDA error "
                           f"{err}")
    _launched(subtb_loss)
    return loss


def subtb_loss_backward(phi: torch.Tensor, length: torch.Tensor,
                        g: torch.Tensor, lam: float = 0.9) -> torch.Tensor:
    """The gradient of :func:`subtb_loss` with respect to ``phi`` for the
    cotangent ``g`` (B,), in closed form:
    ``g * 2 / max(den, 1e-9) * sum_{m<=n, m!=i} lam^|i-m| (phi_i - phi_m)``
    for states i <= n, 0 past n.  Returns (B, T+1) float32: the backward
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    op = "subtb_loss_backward"
    length = _subtb_operands(op, phi, length, lam)
    _require("g", op, g, torch.float32, phi.device, 1)
    if tuple(g.shape) != (phi.shape[0],):
        raise ValueError(f"{op}: cotangent of shape {tuple(g.shape)}")
    return _SubtbLossBackward.apply(phi, length, g, float(lam))


def _subtb_backward(phi, length, g, lam):
    """:func:`subtb_loss_backward` on unwrapped, checked operands."""
    op = "subtb_loss_backward"
    length = _subtb_range(op, phi, length)
    dev = phi.device
    if dev.type == "cpu":
        return ref_subtb_backward(phi, length, lam, g)
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    from . import build
    g = g.contiguous()
    dphi = torch.empty(phi.shape, dtype=torch.float32, device=dev)
    args = _subtb_args(phi, length, lam, g=g, dphi=dphi)
    err = build.library().repro_subtb_bwd(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
    _launched(subtb_loss_backward)
    return dphi


subtb_loss_backward.launches = subtb_loss_backward.captured = 0


class _SubtbLossBackward(_Function):
    """The backward kernel with its batching rule (not differentiated
    again)."""

    @staticmethod
    def forward(phi, length, g, lam):
        return _subtb_backward(phi, length, g, lam)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, phi, length, g, lam):
        S = info.batch_size
        return _unfold(S, _SubtbLossBackward.apply(
            *_fold(S, in_dims, (phi, length, g, lam))))


class _SubtbLoss(_Function):
    @staticmethod
    def forward(phi, length, lam):
        return _subtb_forward(phi, length, lam)

    @staticmethod
    def setup_context(ctx, inputs, output):
        phi, length, lam = inputs
        ctx.save_for_backward(phi, length)
        ctx.lam = lam

    @staticmethod
    def backward(ctx, g):
        phi, length = ctx.saved_tensors
        return subtb_loss_backward(phi, length, g, ctx.lam), None, None

    @staticmethod
    def vmap(info, in_dims, phi, length, lam):
        S = info.batch_size
        return _unfold(S, _SubtbLoss.apply(
            *_fold(S, in_dims, (phi, length, lam))))


def subtb_loss(phi: torch.Tensor, length: torch.Tensor,
               lam: float = 0.9) -> torch.Tensor:
    """Per-trajectory SubTB(lambda) losses from potentials (port of
    ``repro.kernels.ops.subtb_loss``).

    phi: (B, T+1) float32, any strides (the loss passes the transposed view
    of its time-major potentials); length: (B,) int32 or int64 in [0, T],
    converted to int32 once here; 0 < lam <= 1.  Returns (B,):
    ``sum_{j<k<=n} lam^(k-j) (phi_j - phi_k)^2 / max(sum lam^(k-j), 1e-9)``.
    Gradients flow to ``phi`` only, through :func:`subtb_loss_backward`."""
    length = _subtb_operands("subtb_loss", phi, length, lam)
    return _SubtbLoss.apply(phi, length, float(lam))


subtb_loss.launches = subtb_loss.captured = 0


_ATTN_DTYPES = (torch.float32, torch.bfloat16)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel :func:`flash_attention` launches for operands of
    ``dtype`` and head dim ``head_dim`` (<= 128): ``"wgmma"``, the
    tensor-core kernel (``flash_attention_wgmma.cu``), for bfloat16 with
    ``head_dim`` a multiple of 16; else ``"simt"``, the kernel on the fp32
    cores (``flash_attention.cu``), which keeps fp32 operands in fp32."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "wgmma"
    return "simt"


def _needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate through an op on these
    operands (grad mode on, some operand requires grad)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """GQA streaming-softmax attention (port of
    ``repro.kernels.flash_attention.flash_attention_pallas``, with the jnp
    layer's ``q_offset``), differentiable.

    q: (B, Sq, H, D); k/v: (B, Skv, KVH, D) with H % KVH == 0, all float32
    or all bfloat16.  Query row i sits at position ``q_offset + i``; key j
    is attended iff ``j < kv_len`` (``Skv`` when None), and with ``causal``
    ``j <= position``, with ``window`` > 0 ``j > position - window``.
    Scores and softmax in float32; returns (B, Sq, H, D) in q's dtype, zeros
    in a row that attends no key.  On CUDA the kernel takes contiguous
    operands and D <= 128, and :func:`flash_route` picks it by dtype and D
    alone: bfloat16 with D a multiple of 16 runs on the tensor cores (its
    operands 16-byte aligned), everything else on the SIMT kernel.
    ``flash_attention.launches`` counts every launch and
    ``flash_attention.route_launches[route]`` each route's.

    Gradients (q, k, v) come from :func:`flash_attention_backward`: when
    autograd will differentiate the call, the forward also writes each
    row's log-sum-exp for it (nothing more is written otherwise: the serve,
    scoring and decode paths run as before).  A differentiated call with
    ``q_offset != 0`` or ``kv_len < Skv`` raises NotImplementedError: only
    cached decode passes those, and it never differentiates
    (``ROADMAP.md``)."""
    op = "flash_attention"
    dev = q.device
    if q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{op}: q has dtype {q.dtype}, expected float32 or "
                        "bfloat16")
    _require("q", op, q, q.dtype, dev, 4)
    _require("k", op, k, q.dtype, dev, 4)
    _require("v", op, v, q.dtype, dev, 4)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KVH, D) or tuple(v.shape) != tuple(k.shape) \
            or KVH < 1 or H % KVH:
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    window, q_offset = int(window), int(q_offset)
    kv_len = Skv if kv_len is None else int(kv_len)
    if window < 0 or kv_len < 0:
        raise ValueError(f"{op}: window {window} and kv_len {kv_len} must "
                         "not be negative")
    grad = _needs_grad(q, k, v)
    if grad and (q_offset != 0 or kv_len < Skv):
        raise NotImplementedError(
            f"{op}: no gradient with q_offset {q_offset} or kv_len {kv_len} "
            f"< {Skv} (cached decode); differentiate whole-sequence calls "
            "only (ROADMAP.md)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {dev}")
    if dev.type == "cuda":
        if D > 128:
            raise ValueError(f"{op}: the kernel takes head dims up to 128, "
                             f"got {D}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous")
        if flash_route(q.dtype, D) == "wgmma" and any(
                t.data_ptr() % 16 for t in (q, k, v) if t.numel()):
            raise ValueError(f"{op}: the tensor-core kernel reads q, k, v "
                             "through TMA and needs them on 16-byte "
                             "boundaries")
    if not grad:
        return _flash_forward(q, k, v, bool(causal), window, q_offset, kv_len,
                              False)[0]
    return _FlashAttention.apply(q, k, v, bool(causal), window)[0]


def _flash_forward(q, k, v, causal: bool, window: int, q_offset: int,
                   kv_len: int, with_lse: bool):
    """The checked forward: ``(out, lse)``, lse (B, H, Sq) float32 when
    ``with_lse`` (for the backward pass) else None.  The kernel on CUDA,
    the plain version on the CPU."""
    op = "flash_attention"
    dev = q.device
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if dev.type == "cpu":
        out = ref_flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, kv_len=kv_len)
        lse = (ref_flash_attention_lse(q, k, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len)
               if with_lse else None)
        return out, lse
    from . import build
    route = flash_route(q.dtype, D)
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
           if with_lse else None)
    if B * Sq * H == 0:
        return out, lse
    args = build.FlashAttentionArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        lse=None if lse is None else lse.data_ptr(),
        batch=B, q_len=Sq, kv_size=Skv, num_heads=H, num_kv_heads=KVH,
        head_dim=D, causal=int(causal), window=window,
        q_offset=q_offset, kv_len=kv_len,
        bf16=int(q.dtype == torch.bfloat16), device=_device_index(dev))
    lib = build.library()
    launch = (lib.repro_flash_attention_wgmma if route == "wgmma"
              else lib.repro_flash_attention)
    err = launch(ctypes.byref(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    _launched(flash_attention, route)
    return out, lse


class _FlashAttention(_Function):
    """:func:`flash_attention` under autograd (q_offset 0, every key
    valid): the forward with its row log-sum-exp, the backward through
    :func:`flash_attention_backward`."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _flash_forward(q, k, v, causal, window, 0, k.shape[1], True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.kv_shape = tuple(k.shape[1:3])     # (Skv, KVH), for recorders

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA backward kernels :func:`flash_attention_backward` launches
    for operands of ``dtype`` and head dim ``head_dim`` (<= 128):
    ``"wgmma"``, the tensor-core kernels (``flash_attention_bwd_wgmma.cu``),
    for bfloat16 with ``head_dim`` a multiple of 16, the forward's
    tensor-core rule (every training shape of the LM tier); else
    ``"simt"``, the kernels on the fp32 cores (``flash_attention_bwd.cu``),
    which keep fp32 operands in fp32."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "wgmma"
    return "simt"


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` (q_offset
    0, every key valid) for the cotangent ``dout`` of its output ``out``,
    given the forward's row log-sum-exp ``lse`` (B, H, Sq) float32: on CUDA
    tensors the backward kernels of the route :func:`flash_bwd_route` picks
    by dtype and D alone (three launches either way, counted as one in
    ``flash_attention_backward.launches`` and in its route's
    ``flash_attention_backward.route_launches[route]``); on CPU tensors the
    plain version :func:`repro_torch.kernels.ref.ref_flash_attention_bwd`.
    q, k, v, out, dout contiguous and of one dtype (float32 or bfloat16),
    D <= 128; the tensor-core route reads q, k, v on 16-byte boundaries (as
    the forward's does) and copies a ``dout`` that is not.  The gradients
    come in that dtype, dk and dv summed over each kv head's group of query
    heads."""
    op = "flash_attention_backward"
    dev = q.device
    if q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{op}: q has dtype {q.dtype}, expected float32 or "
                        "bfloat16")
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        _require(name, op, t, q.dtype, dev, 4)
    _require("lse", op, lse, torch.float32, dev, 3)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KVH, D) or tuple(v.shape) != tuple(k.shape) \
            or KVH < 1 or H % KVH or tuple(out.shape) != tuple(q.shape) \
            or tuple(dout.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not agree")
    window = int(window)
    if dev.type == "cpu":
        return ref_flash_attention_bwd(q, k, v, out, dout, lse,
                                       causal=bool(causal), window=window)
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    if D > 128:
        raise ValueError(f"{op}: the kernel takes head dims up to 128, got "
                         f"{D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    route = flash_bwd_route(q.dtype, D)
    if route == "wgmma":
        if any(t.data_ptr() % 16 for t in (q, k, v) if t.numel()):
            raise ValueError(f"{op}: the tensor-core kernel reads q, k, v "
                             "through TMA and needs them on 16-byte "
                             "boundaries")
        if dout.data_ptr() % 16:
            dout = dout.clone()
    from . import build
    if B * Sq * H == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if route == "wgmma":
        # every entry is written by the kernels; the scratch holds Delta
        # and lse in log2 units over rows padded to 64
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rows = -(-Sq // 64) * 64
        scratch = torch.empty(2, B, H, rows, dtype=torch.float32,
                              device=dev)
    else:
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        scratch = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
    args = build.FlashAttentionBwdArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        dout=dout.data_ptr(), lse=lse.data_ptr(), delta=scratch.data_ptr(),
        dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(), batch=B,
        q_len=Sq, kv_size=Skv, num_heads=H, num_kv_heads=KVH, head_dim=D,
        causal=int(bool(causal)), window=window,
        bf16=int(q.dtype == torch.bfloat16), device=_device_index(dev))
    lib = build.library()
    launch = (lib.repro_flash_attention_bwd_wgmma if route == "wgmma"
              else lib.repro_flash_attention_bwd)
    err = launch(ctypes.byref(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    _launched(flash_attention_backward, route)
    return dq, dk, dv


flash_attention_backward.launches = flash_attention_backward.captured = 0
flash_attention_backward.route_launches = {"wgmma": 0, "simt": 0}


flash_attention.launches = flash_attention.captured = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}


#: steps per chunk of the chunk-parallel scan kernel (rwkv6_chunk.cu)
SCAN_CHUNK = 64


def scan_route(dtype: torch.dtype, steps: int) -> str:
    """The CUDA kernel :func:`rwkv6_scan` launches for r/k/v of ``dtype``
    over ``steps`` steps: ``"chunk"``, the chunk-parallel tensor-core kernel
    (``rwkv6_chunk.cu``), for bfloat16 with at least one full chunk of
    :data:`SCAN_CHUNK` steps (Hymba's scoring pass); else ``"recurrence"``,
    the step recurrence on the fp32 cores (``rwkv6_scan.cu``): fp32
    operands stay in fp32, and a short call (a decode step, T = 1) is one
    dependent walk either way."""
    if dtype == torch.bfloat16 and steps >= SCAN_CHUNK:
        return "chunk"
    return "recurrence"


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: Optional[torch.Tensor] = None,
               state: Optional[torch.Tensor] = None):
    """The RWKV6 wkv recurrence with an initial state (port of
    ``repro.kernels.rwkv6_scan.rwkv6_scan_pallas``, which starts from
    zeros; the model carries its state, ``models/layers.py:164``),
    differentiable.

    r/k: (B, T, H, Dk) and v: (B, T, H, Dv), all float32 or all bfloat16;
    w: (B, T, H, Dk) float32 or bfloat16, clipped to [1e-8, 1]; u: (H, Dk)
    or None; state: (B, H, Dk, Dv) float32 or None (zeros).  Returns
    ``(o (B, T, H, Dv) in r's dtype, final state (B, H, Dk, Dv) float32)``.
    Every branch computes the step recurrence to float rounding.  On CUDA
    (contiguous r, k, v, w; Dk <= 64) :func:`scan_route` picks the kernel
    by dtype and T alone: bfloat16 with T >= 64 runs the chunk-parallel
    tensor-core kernel, which forms every decay factor as exp of a
    difference of log-cumsums that is <= 0 (or as a product of decays)
    and so stays exact at any decay, where the JAX chunk form (the Pallas
    kernel and ``repro.models.layers.chunked_linear_attention``) divides
    by the running product clamped at 1e-30 and departs from the
    recurrence; the rest runs the step recurrence kernel.  On the CPU the
    plain version :func:`repro_torch.kernels.ref.ref_rwkv6` runs (the JAX
    chunk form is kept as ``ref.chunked_linear_attention_ref`` for the
    tests).
    ``rwkv6_scan.launches`` counts every call that launched a kernel and
    ``rwkv6_scan.route_launches[route]`` each route's (the chunk route's
    three kernels count as one).

    Gradients (r, k, v, w, u, state) come from :func:`rwkv6_scan_backward`
    (Dk, Dv <= 64: a differentiated call past them raises on every
    device): when autograd will differentiate the call, the
    forward also keeps the state entering every 64-step chunk for it (the
    chunk route's carry; the recurrence kernel writes the same).  Through
    the clip, w's gradient is JAX's: 1/2 at w = 1e-8 or w = 1 exactly
    (:func:`repro_torch.kernels.ref.clip_grad`)."""
    op = "rwkv6_scan"
    dev = r.device
    if r.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{op}: r has dtype {r.dtype}, expected float32 or "
                        "bfloat16")
    _require("r", op, r, r.dtype, dev, 4)
    _require("k", op, k, r.dtype, dev, 4)
    _require("v", op, v, r.dtype, dev, 4)
    if w.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{op}: w has dtype {w.dtype}, expected float32 or "
                        "bfloat16")
    _require("w", op, w, w.dtype, dev, 4)
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    if tuple(k.shape) != (B, T, H, Dk) or tuple(w.shape) != (B, T, H, Dk) \
            or tuple(v.shape) != (B, T, H, Dv):
        raise ValueError(f"{op}: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)} do not agree")
    if u is not None:
        if not isinstance(u, torch.Tensor) or u.device != dev \
                or tuple(u.shape) != (H, Dk):
            raise ValueError(f"{op}: u must be an (H, Dk) = {(H, Dk)} "
                             f"tensor on {dev}")
    if state is not None:
        _require("state", op, state, torch.float32, dev, 4)
        if tuple(state.shape) != (B, H, Dk, Dv):
            raise ValueError(f"{op}: state has shape {tuple(state.shape)}, "
                             f"expected {(B, H, Dk, Dv)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {dev}")
    grad = _needs_grad(r, k, v, w, u, state)
    if grad and (Dk > 64 or Dv > 64):
        # on every device, so a CPU run refuses what the card would
        raise ValueError(f"{op}: no gradient with Dk {Dk}, Dv {Dv}: the "
                         "backward kernel takes Dk <= 64 and Dv <= 64")
    if dev.type == "cuda":
        if Dk > 64:
            raise ValueError(f"{op}: the kernel takes Dk <= 64, got {Dk}")
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            if not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous")
    if not grad:
        return _scan_forward(r, k, v, w, u, state, False)[:2]
    out, state_out, _ = _Rwkv6Scan.apply(r, k, v, w, u, state)
    return out, state_out


def _scan_forward(r, k, v, w, u, state, with_carry: bool):
    """The checked forward: ``(o, state_out, carry)``; carry (B, H,
    ceil(T / 64), Dk, Dv) float32, the state entering each 64-step chunk,
    when ``with_carry`` on CUDA (for the backward kernel), else None."""
    op = "rwkv6_scan"
    dev = r.device
    if dev.type == "cpu":
        return ref_rwkv6(r, k, v, w, u, state) + (None,)
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    route = scan_route(r.dtype, T)
    from . import build
    w = w.to(torch.float32)
    u = None if u is None else u.to(torch.float32).contiguous()
    state = None if state is None else state.contiguous()
    out = torch.empty(B, T, H, Dv, dtype=r.dtype, device=dev)
    state_out = torch.empty(B, H, Dk, Dv, dtype=torch.float32, device=dev)
    n = -(-T // SCAN_CHUNK)
    carry = (torch.empty(B, H, n, Dk, Dv, dtype=torch.float32, device=dev)
             if with_carry or route == "chunk" else None)
    common = dict(
        r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=w.data_ptr(),
        u=None if u is None else u.data_ptr(),
        state_in=None if state is None else state.data_ptr(),
        out=out.data_ptr(), state_out=state_out.data_ptr(),
        carry=None if carry is None else carry.data_ptr(), batch=B,
        steps=T, num_heads=H, dk=Dk, dv=Dv, device=_device_index(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "chunk":
        # each chunk's own state, then the state entering it; its decay
        decay = torch.empty(B, H, n, Dk, dtype=torch.float32, device=dev)
        args = build.Rwkv6ChunkArgs(decay=decay.data_ptr(), **common)
        err = build.library().repro_rwkv6_chunk(ctypes.byref(args), stream)
    else:
        args = build.Rwkv6ScanArgs(bf16=int(r.dtype == torch.bfloat16),
                                   **common)
        err = build.library().repro_rwkv6_scan(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    _launched(rwkv6_scan, route)
    return out, state_out, carry if with_carry else None


class _Rwkv6Scan(_Function):
    """:func:`rwkv6_scan` under autograd: the forward keeps its chunk
    states, the backward runs :func:`rwkv6_scan_backward`."""

    @staticmethod
    def forward(r, k, v, w, u, state):
        return _scan_forward(r, k, v, w, u, state, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, state = inputs
        carry = output[2]
        if carry is not None:
            ctx.mark_non_differentiable(carry)
        ctx.save_for_backward(r, k, v, w, u, state, carry)
        ctx.bonus, ctx.has_state = u is not None, state is not None

    @staticmethod
    def backward(ctx, dout, dstate_out, _dcarry):
        r, k, v, w, u, state, carry = ctx.saved_tensors
        dr, dk, dv, dw, du, dstate = rwkv6_scan_backward(
            r, k, v, w, u, state, carry, dout.contiguous(),
            None if dstate_out is None else dstate_out.contiguous())
        return dr, dk, dv, dw, du, None if state is None else dstate


def scan_bwd_route(dtype: torch.dtype, steps: int) -> str:
    """The CUDA backward kernels :func:`rwkv6_scan_backward` launches for
    r/k/v of ``dtype`` over ``steps`` steps: ``"chunk"``, the
    chunk-parallel kernels (``rwkv6_chunk_bwd.cu``, after the adjoint form
    of ``rwkv6_chunk.cu``'s state pass), for bfloat16 with at
    least one full chunk of :data:`SCAN_CHUNK` steps, the forward's chunk
    rule (every training shape of the LM tier); else ``"recurrence"``, the
    step recurrence walked back per (batch row, head)
    (``rwkv6_scan_bwd.cu``), which keeps fp32 operands in fp32."""
    if dtype == torch.bfloat16 and steps >= SCAN_CHUNK:
        return "chunk"
    return "recurrence"


def rwkv6_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: Optional[torch.Tensor],
                        state: Optional[torch.Tensor],
                        carry: Optional[torch.Tensor], dout: torch.Tensor,
                        dstate_out: Optional[torch.Tensor]):
    """The gradients ``(dr, dk, dv, dw, du, dstate)`` of
    :func:`rwkv6_scan` for the cotangents ``dout`` (B, T, H, Dv) of its
    output and ``dstate_out`` (B, H, Dk, Dv) float32 of its final state
    (None: zeros), in the dtypes of r, k, v, w, u (None without u) and
    float32.  On CUDA tensors the backward kernels of the route
    :func:`scan_bwd_route` picks by dtype and T alone (one call counted in
    ``rwkv6_scan_backward.launches`` and in its route's
    ``rwkv6_scan_backward.route_launches[route]``; Dk, Dv <= 64) read
    ``carry`` (B, H, ceil(T / 64), Dk, Dv), the state entering each 64-step
    chunk that the forward of either route kept; on CPU tensors the plain
    version
    :func:`repro_torch.kernels.ref.ref_rwkv6_bwd` recomputes the states
    from ``state`` and ignores ``carry``.  Through the clip, w's gradient is
    JAX's: 1/2 at w = 1e-8 or w = 1 exactly."""
    op = "rwkv6_scan_backward"
    dev = r.device
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    for name, t, shape in (("k", k, (B, T, H, Dk)), ("v", v, (B, T, H, Dv)),
                           ("dout", dout, (B, T, H, Dv))):
        _require(name, op, t, r.dtype, dev, 4)
        if tuple(t.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if dstate_out is not None:
        _require("dstate_out", op, dstate_out, torch.float32, dev, 4)
        if tuple(dstate_out.shape) != (B, H, Dk, Dv):
            raise ValueError(f"{op}: dstate_out has shape "
                             f"{tuple(dstate_out.shape)}")
    if dev.type == "cpu":
        return ref_rwkv6_bwd(r, k, v, w, u, state, dout, dstate_out)
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    if Dk > 64 or Dv > 64:
        raise ValueError(f"{op}: the kernel takes Dk, Dv <= 64, got "
                         f"{Dk}, {Dv}")
    n = -(-T // SCAN_CHUNK)
    if carry is None or tuple(carry.shape) != (B, H, n, Dk, Dv) \
            or carry.dtype != torch.float32 or not carry.is_contiguous():
        raise ValueError(f"{op}: carry must be the forward's (B, H, {n}, Dk, "
                         "Dv) float32 chunk states")
    for name, t in (("r", r), ("k", k), ("v", v), ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    from . import build
    wf = w.to(torch.float32).contiguous()
    uf = None if u is None else u.to(torch.float32).contiguous()
    dr, dk = torch.empty_like(r), torch.empty_like(k)
    dv = torch.empty_like(v)
    dw = torch.empty(B, T, H, Dk, dtype=torch.float32, device=dev)
    dstate = torch.empty(B, H, Dk, Dv, dtype=torch.float32, device=dev)
    route = scan_bwd_route(r.dtype, T)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "chunk":
        # pass 1, each chunk's own adjoint and its decay, is the forward's
        # state pass in its adjoint form (k = r, v = dO); passes 2-4 then
        # overwrite gstate with the adjoint at each chunk's end and walk
        # it; du per chunk, summed below in a fixed order
        lib = build.library()
        gstate = torch.empty(B, H, n, Dk, Dv, dtype=torch.float32,
                             device=dev)
        decay = torch.empty(B, H, n, Dk, dtype=torch.float32, device=dev)
        du = (None if u is None else
              torch.empty(B, H, n, Dk, dtype=torch.float32, device=dev))
        local = build.Rwkv6ChunkArgs(
            r=r.data_ptr(), k=r.data_ptr(), v=dout.data_ptr(),
            w=wf.data_ptr(), carry=gstate.data_ptr(),
            decay=decay.data_ptr(), batch=B, steps=T, num_heads=H, dk=Dk,
            dv=Dv, device=_device_index(dev))
        err = lib.repro_rwkv6_chunk_adjoint(ctypes.byref(local), stream)
        if err != 0:
            raise RuntimeError(f"{op} kernel launch failed (chunk route, "
                               f"pass 1): CUDA error {err}")
        args = build.Rwkv6ChunkBwdArgs(
            r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=wf.data_ptr(),
            u=None if uf is None else uf.data_ptr(), carry=carry.data_ptr(),
            dout=dout.data_ptr(),
            dstate_out=None if dstate_out is None else dstate_out.data_ptr(),
            gstate=gstate.data_ptr(), decay=decay.data_ptr(),
            grad_r=dr.data_ptr(), grad_k=dk.data_ptr(), grad_v=dv.data_ptr(),
            grad_w=dw.data_ptr(), grad_u=None if du is None else du.data_ptr(),
            grad_state=dstate.data_ptr(), batch=B, steps=T, num_heads=H,
            dk=Dk, dv=Dv, device=_device_index(dev))
        err = lib.repro_rwkv6_chunk_bwd(ctypes.byref(args), stream)
        du_sum = (0, 2)
    else:
        du = (None if u is None else
              torch.empty(B, H, Dk, dtype=torch.float32, device=dev))
        pad = lambda d: 16 if d <= 16 else 32 if d <= 32 else 64
        scratch = torch.empty(B * H * SCAN_CHUNK * pad(Dk) * pad(Dv),
                              dtype=torch.float32, device=dev)
        args = build.Rwkv6ScanBwdArgs(
            r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=wf.data_ptr(),
            u=None if uf is None else uf.data_ptr(), carry=carry.data_ptr(),
            dout=dout.data_ptr(),
            dstate_out=None if dstate_out is None else dstate_out.data_ptr(),
            scratch=scratch.data_ptr(), grad_r=dr.data_ptr(),
            grad_k=dk.data_ptr(), grad_v=dv.data_ptr(), grad_w=dw.data_ptr(),
            grad_u=None if du is None else du.data_ptr(),
            grad_state=dstate.data_ptr(), batch=B, steps=T, num_heads=H,
            dk=Dk, dv=Dv, bf16=int(r.dtype == torch.bfloat16),
            device=_device_index(dev))
        err = build.library().repro_rwkv6_scan_bwd(ctypes.byref(args), stream)
        du_sum = 0
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    _launched(rwkv6_scan_backward, route)
    return (dr, dk, dv, dw.to(w.dtype),
            None if du is None else du.sum(du_sum).to(u.dtype), dstate)


rwkv6_scan_backward.launches = rwkv6_scan_backward.captured = 0
rwkv6_scan_backward.route_launches = {"chunk": 0, "recurrence": 0}


rwkv6_scan.launches = rwkv6_scan.captured = 0
rwkv6_scan.route_launches = {"chunk": 0, "recurrence": 0}
