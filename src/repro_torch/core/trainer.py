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


def make_optimizer(cfg: GFNConfig, params: torch.nn.Module
                   ) -> torch.optim.Adam:
    """Adam with its own lr for the ``log_z`` leaves (paper Tables 3-7).

    The JAX package chains ``scale_by_adam``, ``scale_by_label`` (log Z
    updates times ``log_z_lr / lr``) and ``scale(-lr)``
    (``repro/core/trainer.py:40-53``); that is Adam (b1 0.9, b2 0.999,
    eps 1e-8, eps outside the square root) with a second parameter group
    at ``log_z_lr``.  On CUDA it is built ``capturable`` (its step count
    and bias corrections stay on the device), so that an eager step and a
    step captured in a CUDA graph run the same update arithmetic.
    Gradient clipping and weight decay raise until a ported recipe needs
    them."""
    if cfg.max_grad_norm is not None:
        raise NotImplementedError("make_optimizer: max_grad_norm is not "
                                  "ported yet")
    if cfg.weight_decay:
        raise NotImplementedError("make_optimizer: weight_decay is not "
                                  "ported yet")
    named = list(params.named_parameters())
    log_z = [p for n, p in named if "log_z" in n]
    rest = [p for n, p in named if "log_z" not in n]
    groups = [{"params": rest, "lr": cfg.lr}]
    if log_z:
        groups.append({"params": log_z, "lr": cfg.log_z_lr or cfg.lr})
    return torch.optim.Adam(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=named[0][1].is_cuda)


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
