"""Optimizers as chains of functional transforms (port of
``repro.optim.adamw``), with its optax-like contract:

    tx = adamw(lr=1e-3); state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are dicts of tensors keyed by JAX's
flattened leaf names (``log_z``, ``model/layers/attn/wq``); a transform's
state is what JAX's is -- ``()``, a 0-dim int32 count, or
:class:`AdamState` -- and a chain's state is the tuple of its parts'.
:func:`state_leaves` names every leaf as JAX's checkpoint manager does
(``1/.count``, ``1/.mu/log_z``), so a state moves between the packages
leaf by leaf.

The arithmetic is JAX's, transform by transform, and not
``torch.optim.AdamW``'s: the moments are float32 whatever the parameters'
dtype, the decay ``wd * p`` (in float32) is added *after* Adam's update and
before the label and learning-rate scales (so the log Z group's ratio
scales its decay too), and an update is added as ``p + u.to(p.dtype)``.
Where JAX promotes a bf16 gradient to float32 (times the clip's float32
scale), the port casts first.

Memory: a transform builds its output leaf by leaf, so its temporaries
are one leaf's, and :func:`scale_by_adam` updates ``mu`` and ``nu`` in
place (the same fp32 operations in the same order, so the same bits):
``update`` consumes the state it is given, whose tensors are the returned
state's.  Nothing here reads the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]
f32 = torch.float32


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def _names(tree: Mapping[str, Any]):
    """Leaf names in JAX's leaf order (sorted path components, which the
    ``/``-joined names sort the same as)."""
    return sorted(tree)


def _weak(factor: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing reads it beside an array of
    ``dtype``: rounded to that dtype first (bf16 times a Python float is a
    bf16 product of two bf16 values)."""
    return float(torch.tensor(factor, dtype=dtype)) \
        if dtype in (torch.bfloat16, torch.float16) else factor


def apply_updates(params: Params, updates: Params) -> Params:
    """``p + u.to(p.dtype)`` per leaf (a leaf whose update is None is
    kept), as new tensors."""
    return {n: (p + updates[n].to(p.dtype)
                if updates.get(n) is not None else p)
            for n, p in params.items()}


def apply_updates_(params: Mapping[str, torch.Tensor],
                   updates: Params) -> None:
    """:func:`apply_updates` in place, under no_grad: the same sums (one
    rounding to each parameter's dtype), into the parameters' storage."""
    with torch.no_grad():
        for n in _names(params):
            if updates.get(n) is not None:
                params[n].add_(updates[n].to(params[n].dtype))


def chain(*txs: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(txs, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale the gradients by ``min(1, max_norm / (norm + 1e-9))``, the
    norm over every leaf in float32.  The result is float32 (JAX's bf16
    gradient times the float32 scale promotes)."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        names = _names(grads)
        gn = torch.sqrt(sum(torch.sum(torch.square(grads[n].to(f32)))
                            for n in names))
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        return {n: grads[n].to(f32) * scale for n in names}, state

    return Transform(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor   # 0-dim int32
    mu: Params            # float32
    nu: Params            # float32


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        z = {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), z,
                         {n: t.clone() for n, t in z.items()})

    def update(grads, state, params=None):
        """``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g g`` in
        place; the update ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` new."""
        count = state.count + 1
        cf = count.to(f32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=cf.device), cf)
        out = {}
        for n in _names(grads):
            g, mu, nu = grads[n].to(f32), state.mu[n], state.nu[n]
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(g * g * (1 - b2))
            out[n] = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
        return out, AdamState(count, state.mu, state.nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable] = None) -> Transform:
    """``g + weight_decay * p`` (p in float32) on every leaf, or on those
    ``mask(params)`` marks (a dict of bools by name)."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        if weight_decay == 0.0 or params is None:
            return grads, state
        keep = mask(params) if mask is not None else None
        out = dict(grads)
        for n in _names(grads):
            if keep is None or keep[n]:
                out[n] = grads[n] + weight_decay * params[n].to(f32)
        return out, state

    return Transform(init, update)


def scale(factor: float) -> Transform:
    return Transform(
        lambda p: (),
        lambda g, s, p=None: ({n: _weak(factor, x.dtype) * x
                               for n, x in g.items()}, s))


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Transform:
    """``-schedule(count) * g``; the state is the 0-dim int32 count."""
    def init(params):
        dev = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.int32, device=dev)

    def update(grads, state, params=None):
        lr = schedule(state)
        # a 0-dim float32 array promotes a bf16 gradient in JAX
        return {n: -lr * g.to(torch.promote_types(g.dtype, f32))
                for n, g in grads.items()}, state + 1

    return Transform(init, update)


def scale_by_label(label_fn: Callable[[str], str],
                   lrs: Mapping[str, float]) -> Transform:
    """Per-leaf learning-rate groups by the leaf's ``/``-joined name."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        return {n: _weak(lrs[label_fn(n)], g.dtype) * g
                for n, g in grads.items()}, state

    return Transform(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0,
         max_grad_norm: Optional[float] = None) -> Transform:
    parts = []
    if max_grad_norm is not None:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(scale_by_adam(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if callable(lr):
        parts.append(scale_by_schedule(lr))  # applies -lr(step) * g
    else:
        parts.append(scale(-lr))
    return chain(*parts)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-5,
          max_grad_norm: Optional[float] = None) -> Transform:
    return adam(lr, b1, b2, eps, weight_decay, max_grad_norm)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_lr: float = 0.0
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to ``final_lr`` at ``total_steps``; of a count tensor, in float32."""
    def sched(count):
        c = count.to(f32)
        warm = base_lr * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = final_lr + 0.5 * (base_lr - final_lr) * (
            1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup, warm, cos)

    return sched


def linear_anneal(start: float, end: float, steps: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(count):
        frac = torch.clamp(count.to(f32) / max(steps, 1), 0.0, 1.0)
        return start + (end - start) * frac

    return sched


# ---------------------------------------------------------------------------
# Leaf names (JAX's checkpoint manager's)
# ---------------------------------------------------------------------------

def state_leaves(state: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a transform state (or a parameter tree) by its
    flattened name, as ``repro.checkpoint.manager._flatten`` names JAX's: a
    tuple entry by its index, :class:`AdamState`'s fields as ``.count`` /
    ``.mu`` / ``.nu``, a dict's or ``ParamTree``'s entries by key
    (``/``-joined); empty states name nothing.  The tensors are the
    state's own (no copies)."""
    out: Dict[str, torch.Tensor] = {}
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(state, torch.Tensor):
        out[prefix] = state
    elif isinstance(state, AdamState):
        out[join(".count")] = state.count
        for field in ("mu", "nu"):
            for n, t in getattr(state, field).items():
                out[join(f".{field}/{n}")] = t
    elif isinstance(state, tuple):
        for i, s in enumerate(state):
            out.update(state_leaves(s, join(i)))
    elif isinstance(state, Mapping) or hasattr(state, "_keys"):
        # a dict of tensors, or a ``ParamTree`` (keyed like one)
        for n in state:
            out.update(state_leaves(state[n], join(n)))
    else:
        raise TypeError(f"state_leaves: {type(state).__name__} at {prefix!r}")
    return out
