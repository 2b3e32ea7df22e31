"""Training configuration, optimizer and loss (port of the parts of
``repro.core.trainer`` the on-policy loop uses)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .objectives import evaluate_trajectory, objective_parts
from .rollout import RolloutBatch


class GFNConfig(NamedTuple):
    """Training configuration: the fields, defaults and order of
    ``repro.core.trainer.GFNConfig``, so a config built positionally means
    the same in both packages."""
    objective: str = "tb"
    num_envs: int = 16
    lr: float = 1e-3
    log_z_lr: Optional[float] = 1e-1
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    subtb_lambda: float = 0.9
    exploration_eps: float = 0.0
    exploration_anneal_steps: int = 0
    stop_action: Optional[int] = None


def make_optimizer(cfg: GFNConfig, params: torch.nn.Module,
                   seeds: Optional[int] = None) -> torch.optim.Optimizer:
    """Adam with its own lr for the ``log_z`` leaves (paper Tables 3-7),
    with the JAX package's gradient clip and weight decay.

    The JAX package chains ``clip_by_global_norm`` (when
    ``max_grad_norm`` is set), ``scale_by_adam``, ``add_decayed_weights``
    (when ``weight_decay`` is set), ``scale_by_label`` (log Z updates times
    ``log_z_lr / lr``) and ``scale(-lr)`` (``repro/core/trainer.py:38-52``).
    Adam is b1 0.9, b2 0.999, eps 1e-8 outside the square root, with a
    second parameter group at ``log_z_lr``.  The decay is added to Adam's
    update of every leaf, ``log_z`` included, and so scaled by its group's
    lr: that is :class:`torch.optim.AdamW`'s ``p -= lr * wd * p`` (the same
    arithmetic up to rounding).  The clip runs before each ``step()``, as
    a step pre-hook (:func:`clip_by_global_norm_`).  On CUDA the optimizer
    is built ``capturable`` (its step count and bias corrections stay on
    the device), so that an eager step and a step captured in a CUDA graph
    run the same update arithmetic.  Learning-rate schedules are not
    ported: no ``GFNConfig`` field reaches them.

    ``seeds`` S: every leaf of ``params`` stacks S independent runs' leaves
    along axis 0 (a seed plan).  Adam and the decay are elementwise, so one
    optimizer over the stacked leaves is S optimizers; the clip takes each
    seed's own global norm (:func:`clip_by_global_norm_`); ``log_z`` stays
    its own group."""
    named = list(params.named_parameters())
    log_z = [p for n, p in named if "log_z" in n]
    rest = [p for n, p in named if "log_z" not in n]
    groups = [{"params": rest, "lr": cfg.lr}]
    if log_z:
        groups.append({"params": log_z, "lr": cfg.log_z_lr or cfg.lr})
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
              capturable=named[0][1].is_cuda)
    if cfg.weight_decay:
        opt = torch.optim.AdamW(groups, weight_decay=cfg.weight_decay, **kw)
    else:
        opt = torch.optim.Adam(groups, **kw)
    if cfg.max_grad_norm is not None:
        max_norm = float(cfg.max_grad_norm)
        leaves = [p for _, p in named]
        opt.register_step_pre_hook(
            lambda *_: clip_by_global_norm_(leaves, max_norm, seeds=seeds))
    return opt


def clip_by_global_norm_(params, max_norm: float,
                         seeds: Optional[int] = None) -> None:
    """Scale every gradient by ``min(1, max_norm / (gn + 1e-9))``, ``gn``
    the global norm over all of them (``repro/optim/adamw.py:46-55``), in
    place and on the device: no host read, so it runs inside a captured
    iteration.  ``max_norm`` is divided as a tensor (CUDA turns a Python
    number divided by a tensor into a product with the tensor's
    reciprocal).  With ``seeds`` S the leaves are seed-stacked: each
    seed's norm reduces every axis but the leading one, and scales that
    seed's rows."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    with torch.no_grad():
        if seeds:
            gn = torch.sqrt(torch.stack(
                [g.float().square().reshape(seeds, -1).sum(1)
                 for g in grads]).sum(0))
        else:
            gn = torch.sqrt(torch.stack(
                [g.float().square().sum() for g in grads]).sum())
        num = torch.full((), max_norm, dtype=torch.float32, device=gn.device)
        scale = torch.clamp(num / (gn + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale.view(scale.shape + (1,) * (g.dim() - scale.dim()))
                   .to(g.dtype))


def current_eps(cfg: GFNConfig, step: int) -> float:
    """The exploration epsilon of iteration ``step``, in float32 as the JAX
    package computes it (linear anneal to 0 over
    ``exploration_anneal_steps``, when that is positive)."""
    eps = np.float32(cfg.exploration_eps)
    if cfg.exploration_anneal_steps > 0:
        frac = np.clip(np.float32(step)
                       / np.float32(cfg.exploration_anneal_steps),
                       np.float32(0), np.float32(1))
        eps = eps * (np.float32(1) - frac)
    return float(eps)


def current_eps_tensor(cfg: GFNConfig, step: torch.Tensor) -> torch.Tensor:
    """:func:`current_eps` of a 0-dim integer ``step`` tensor, as a 0-dim
    float32 tensor on its device (the JAX package's ``current_eps(cfg,
    step: jax.Array)``): the same float32 operations in the same order,
    so it is bitwise the host value at every step.  The anneal divides by
    a tensor, not a Python number, which CUDA would turn into a product
    with the number's reciprocal."""
    f32 = dict(dtype=torch.float32, device=step.device)
    eps = torch.full((), float(np.float32(cfg.exploration_eps)), **f32)
    if cfg.exploration_anneal_steps > 0:
        steps = torch.full((), float(cfg.exploration_anneal_steps), **f32)
        frac = torch.clamp(step.to(torch.float32) / steps, 0.0, 1.0)
        eps = eps * (1.0 - frac)
    return eps


def make_loss_parts_fn(env, policy, cfg: GFNConfig):
    """The objective as additive ``(sum, weight)`` parts over a batch:
    ``loss == sum / max(weight, 1)``.  Differentiate the sum, then divide
    the gradients by the clamped weight (``repro.algo.loop``'s order)."""
    parts = objective_parts(cfg.objective)

    def parts_fn(batch: RolloutBatch):
        ev = evaluate_trajectory(policy, batch, stop_action=cfg.stop_action)
        return parts(ev, batch, policy.params, cfg)

    return parts_fn
