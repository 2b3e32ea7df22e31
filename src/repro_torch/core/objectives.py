"""GFlowNet training objectives (port of the categorical, no-stop-action
path of ``repro.core.objectives``).

Every objective consumes a :class:`repro_torch.core.rollout.RolloutBatch`
and re-evaluates the policy on the stored observations (teacher forcing).
Both directions' log-probabilities go through
:func:`repro_torch.kernels.ops.traj_logprob`: mask + log-softmax + action
gather in one kernel per direction on CUDA, with the closed-form gradient
as a second kernel; the plain version on the CPU.  Ported so far: TB.  DB,
SubTB, FLDB and MDB raise by name.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels.ops import traj_logprob
from .rollout import RolloutBatch


class TrajEval(NamedTuple):
    """Differentiable per-trajectory quantities under the current params.

    log_pf      (T, B)   log P_F(a_t | s_t), 0 where the transition is not
                         valid
    log_pb      (T, B)   log P_B(s_t | s_{t+1}), same convention
    log_flow    (T+1, B) flow head at s_t (zeros if the policy lacks one)
    log_pf_stop (T+1, B) log P_F(stop | s_t) (zeros: no stop action)
    """
    log_pf: torch.Tensor
    log_pb: torch.Tensor
    log_flow: torch.Tensor
    log_pf_stop: torch.Tensor


def evaluate_trajectory(policy, batch: RolloutBatch,
                        stop_action: Optional[int] = None) -> TrajEval:
    """Teacher-force ``policy.apply`` over the batch's (T+1)·B observations.

    The time-major logits reach :func:`traj_logprob` as (B, T, A) views
    (transposed, not copied: the kernel takes their strides).  A policy
    without a ``logits_b`` head gives the uniform backward policy through
    constant zero logits, so that call builds no gradient and never runs
    the backward kernel.  ``traj_logprob`` already zeroes steps whose
    ``valid`` is False."""
    if stop_action is not None:
        raise NotImplementedError(
            "evaluate_trajectory: envs with a stop action need the full "
            "log-softmax tensor, which the port does not build yet")
    Tp1, B = batch.obs.shape[:2]
    out = policy.apply(batch.obs.reshape((Tp1 * B,) + batch.obs.shape[2:]))

    def unflat(x):
        return x.reshape((Tp1, B) + x.shape[1:])

    valid_bt = batch.valid.T
    logits = unflat(out["logits"])
    _, pf_step = traj_logprob(logits[:-1].transpose(0, 1), batch.actions.T,
                              batch.fwd_mask[:-1].transpose(0, 1), valid_bt)
    if "logits_b" in out:
        logits_b = unflat(out["logits_b"])
    else:
        logits_b = torch.zeros(batch.bwd_mask.shape, dtype=torch.float32,
                               device=batch.bwd_mask.device)
    _, pb_step = traj_logprob(logits_b[1:].transpose(0, 1),
                              batch.bwd_actions.T,
                              batch.bwd_mask[1:].transpose(0, 1), valid_bt)
    zeros = torch.zeros((Tp1, B), dtype=torch.float32, device=logits.device)
    log_flow = unflat(out["log_flow"]) if "log_flow" in out else zeros
    return TrajEval(log_pf=pf_step.T, log_pb=pb_step.T, log_flow=log_flow,
                    log_pf_stop=zeros)


def tb_parts(ev: TrajEval, batch: RolloutBatch,
             log_z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectory Balance, Eq. (4), as an unreduced (sum, count) pair:
    ``loss == sum / max(count, 1)``."""
    delta = log_z + ev.log_pf.sum(0) - batch.log_reward - ev.log_pb.sum(0)
    return delta.square().sum(), torch.tensor(
        float(batch.log_reward.shape[0]), device=delta.device)


PartsFn = Callable[[TrajEval, RolloutBatch, Dict, object],
                   Tuple[torch.Tensor, torch.Tensor]]

#: objective name -> ``parts(ev, batch, params, cfg) -> (sum, weight)``,
#: the additive form of ``repro.core.objectives.OBJECTIVE_PARTS``
OBJECTIVE_PARTS: Dict[str, PartsFn] = {
    "tb": lambda ev, batch, params, cfg: tb_parts(ev, batch,
                                                  params["log_z"]),
}

#: objectives of the JAX package that the port does not have yet
NOT_PORTED = ("db", "subtb", "fldb", "mdb")


def objective_parts(name: str) -> PartsFn:
    """The parts function of objective ``name``; raises on the JAX
    package's objectives that are not ported yet, and on unknown names."""
    if name in OBJECTIVE_PARTS:
        return OBJECTIVE_PARTS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"objective {name!r} is not ported yet; "
                                  f"ported: {sorted(OBJECTIVE_PARTS)}")
    raise KeyError(f"unknown objective {name!r}")
