"""GFlowNet training objectives (port of the categorical path of
``repro.core.objectives``): TB, DB, SubTB, FLDB and MDB.

Every objective consumes a :class:`repro_torch.core.rollout.RolloutBatch`
and re-evaluates the policy on the stored observations (teacher forcing).
Without a stop action, both directions' log-probabilities go through
:func:`repro_torch.kernels.ops.traj_logprob`: mask + log-softmax + action
gather in one kernel per direction on CUDA, with the closed-form gradient
as a second kernel; the plain version on the CPU.  With a stop action
(hypergrid, AMP, the DAG env's MDB) the full log-softmax tensor is built,
as the JAX package does off the TPU, and no kernel runs.  SubTB's
per-trajectory loss goes through :func:`repro_torch.kernels.ops.subtb_loss`
(a kernel pair on CUDA).  FLDB reads the batch's energies, MDB its
per-state log-rewards and log P_F(stop).

A policy with density heads (the flow policy of a continuous env,
:mod:`repro_torch.nn.flows`; :func:`has_density_heads`) is teacher-forced
through ``log_prob`` / ``log_prob_b`` instead, on its stored float actions; that choice is made before any
:func:`traj_logprob` call, so float actions never reach a kernel.  TB and
DB consume the log-densities unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels.ops import subtb_loss as subtb_kernel
from ..kernels.ops import traj_logprob
from .rollout import RolloutBatch, has_density_heads
from .types import masked_logprobs


class TrajEval(NamedTuple):
    """Differentiable per-trajectory quantities under the current params.

    log_pf      (T, B)   log P_F(a_t | s_t), 0 where the transition is not
                         valid
    log_pb      (T, B)   log P_B(s_t | s_{t+1}), same convention
    log_flow    (T+1, B) flow head at s_t (zeros if the policy lacks one)
    log_pf_stop (T+1, B) log P_F(stop | s_t) (zeros without a stop action)
    """
    log_pf: torch.Tensor
    log_pb: torch.Tensor
    log_flow: torch.Tensor
    log_pf_stop: torch.Tensor


def _gather(logp: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def _evaluate_trajectory_continuous(policy, batch: RolloutBatch
                                    ) -> TrajEval:
    """The density path (JAX's ``_evaluate_trajectory_continuous``): the
    policy's ``log_prob`` / ``log_prob_b`` / ``log_state_flow`` on the
    stored observations and float actions.  The torso runs once over the
    (T+1)·B observations; P_F reads its rows 0..T-1, P_B rows 1..T."""
    out = policy.torso(batch.obs)
    log_pf = policy.log_prob(batch.obs[:-1], batch.actions, out[:-1])
    log_pb = policy.log_prob_b(batch.obs[1:], batch.bwd_actions, out[1:])
    v = batch.valid
    return TrajEval(log_pf=torch.where(v, log_pf, 0.0),
                    log_pb=torch.where(v, log_pb, 0.0),
                    log_flow=policy.log_state_flow(batch.obs, out),
                    log_pf_stop=torch.zeros(batch.done.shape,
                                            dtype=torch.float32,
                                            device=batch.done.device))


def evaluate_trajectory(policy, batch: RolloutBatch,
                        stop_action: Optional[int] = None) -> TrajEval:
    """Teacher-force ``policy.apply`` over the batch's (T+1)·B observations.

    Without a stop action the time-major logits reach :func:`traj_logprob`
    as (B, T, A) views (transposed, not copied: the kernel takes their
    strides).  With one, ``masked_logprobs`` of all (T+1)·B rows gives
    log P_F, log P_B and ``log_pf_stop = logp_f[..., stop_action]``; a
    terminal row is all illegal and its log-softmax is uniform, not NaN.
    A policy without a ``logits_b`` head gives the uniform backward policy
    through constant zero logits, which build no gradient.  A policy with
    density heads takes :func:`_evaluate_trajectory_continuous`."""
    if has_density_heads(policy):
        return _evaluate_trajectory_continuous(policy, batch)
    Tp1, B = batch.obs.shape[:2]
    out = policy.apply(batch.obs.reshape((Tp1 * B,) + batch.obs.shape[2:]))

    def unflat(x):
        return x.reshape((Tp1, B) + x.shape[1:])

    logits = unflat(out["logits"])
    if "logits_b" in out:
        logits_b = unflat(out["logits_b"])
    else:
        logits_b = torch.zeros(batch.bwd_mask.shape, dtype=torch.float32,
                               device=batch.bwd_mask.device)
    zeros = torch.zeros((Tp1, B), dtype=torch.float32, device=logits.device)
    log_flow = unflat(out["log_flow"]) if "log_flow" in out else zeros
    if stop_action is not None:
        logp_f = masked_logprobs(logits, batch.fwd_mask)
        logp_b = masked_logprobs(logits_b, batch.bwd_mask)
        v = batch.valid
        return TrajEval(
            log_pf=torch.where(v, _gather(logp_f[:-1], batch.actions), 0.0),
            log_pb=torch.where(v, _gather(logp_b[1:], batch.bwd_actions),
                               0.0),
            log_flow=log_flow, log_pf_stop=logp_f[..., stop_action])
    valid_bt = batch.valid.T
    _, pf_step = traj_logprob(logits[:-1].transpose(0, 1), batch.actions.T,
                              batch.fwd_mask[:-1].transpose(0, 1), valid_bt)
    _, pb_step = traj_logprob(logits_b[1:].transpose(0, 1),
                              batch.bwd_actions.T,
                              batch.bwd_mask[1:].transpose(0, 1), valid_bt)
    return TrajEval(log_pf=pf_step.T, log_pb=pb_step.T, log_flow=log_flow,
                    log_pf_stop=zeros)


def tb_parts(ev: TrajEval, batch: RolloutBatch,
             log_z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectory Balance, Eq. (4), as an unreduced (sum, count) pair:
    ``loss == sum / max(count, 1)``."""
    delta = log_z + ev.log_pf.sum(0) - batch.log_reward - ev.log_pb.sum(0)
    return delta.square().sum(), torch.full(
        (), float(batch.log_reward.shape[0]), device=delta.device)


def _flow_targets(ev: TrajEval, batch: RolloutBatch) -> torch.Tensor:
    """log F(s_t), t = 0..T, with terminal states pinned to log R(x)."""
    return torch.where(batch.done, batch.log_reward[None, :], ev.log_flow)


def db_parts(ev: TrajEval, batch: RolloutBatch
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detailed Balance, Eq. (3), as (residual sum, valid-transition
    count), with F(terminal) := R."""
    flows = _flow_targets(ev, batch)
    delta = flows[:-1] + ev.log_pf - flows[1:] - ev.log_pb
    delta = torch.where(batch.valid, delta, 0.0)
    return delta.square().sum(), batch.valid.sum().to(torch.float32)


#: beyond this many states the CPU takes the O(T) prefix recurrence in
#: place of the dense pairwise form (JAX's ``impl="auto"`` off the TPU)
_SUBTB_DENSE_MAX_T1 = 64


def _subtb_phi(ev: TrajEval, batch: RolloutBatch):
    """Flow-corrected potentials phi (T+1, B) and lengths (B,) int64.

    With c_t = sum_{u<t}(log_pf - log_pb) and phi_t = log F(s_t) - c_t, the
    (j, k) subtrajectory residual is phi_j - phi_k; state t is on the
    trajectory iff t <= n, n = the number of valid transitions."""
    flows = _flow_targets(ev, batch)
    c = torch.cumsum(ev.log_pf - ev.log_pb, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    return flows - c, batch.valid.sum(0)


def _subtb_prefix(phi: torch.Tensor, length: torch.Tensor,
                  lam: float) -> torch.Tensor:
    """The O(T) prefix-sum recurrence over k (no pairwise tensor): with
    S2_k, S1_k, W_k the lam-discounted sums over j < k of phi_j^2, phi_j
    and 1, num = sum_k S2_k - 2 phi_k S1_k + phi_k^2 W_k over k <= n."""
    T1, B = phi.shape
    s2 = s1 = w = num = den = torch.zeros(B, dtype=torch.float32,
                                          device=phi.device)
    for k in range(1, T1):
        on = k <= length
        s2 = lam * (s2 + phi[k - 1].square())
        s1 = lam * (s1 + phi[k - 1])
        w = lam * (w + 1.0)
        term = s2 - 2.0 * phi[k] * s1 + phi[k].square() * w
        num = num + torch.where(on, term, 0.0)
        den = den + torch.where(on, w, 0.0)
    return num / torch.clamp(den, min=1e-9)


def subtb_loss(ev: TrajEval, batch: RolloutBatch,
               lam: float = 0.9) -> torch.Tensor:
    """Subtrajectory Balance, Eq. (5), weights lambda^(k-j), normalised per
    trajectory, then averaged.  On CUDA the per-trajectory loss is the
    :func:`repro_torch.kernels.ops.subtb_loss` kernel pair; on the CPU it
    is that wrapper's dense plain version up to 64 states and the O(T)
    prefix recurrence beyond (JAX's ``impl="auto"`` off the TPU)."""
    phi, length = _subtb_phi(ev, batch)
    if phi.device.type == "cuda" or phi.shape[0] <= _SUBTB_DENSE_MAX_T1:
        return subtb_kernel(phi.T, length, lam).mean()
    return _subtb_prefix(phi, length, lam).mean()


def subtb_parts(ev: TrajEval, batch: RolloutBatch, lam: float = 0.9
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`subtb_loss` as (per-trajectory sum, trajectory count)."""
    B = ev.log_pf.shape[1]
    return subtb_loss(ev, batch, lam) * B, torch.full(
        (), float(B), device=ev.log_pf.device)


def fldb_parts(ev: TrajEval, batch: RolloutBatch
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-Looking DB, Eq. (7), as (residual sum, valid-transition
    count).  The env's energies have E(s0) = 0 and E(x) = -log R(x), so
    the forward-looking flow target at a terminal is
    log F~(x) = log R(x) + E(x) = 0."""
    flows = torch.where(batch.done, 0.0, ev.log_flow)
    d_energy = batch.energy[1:] - batch.energy[:-1]
    delta = flows[:-1] + ev.log_pf - flows[1:] - ev.log_pb + d_energy
    delta = torch.where(batch.valid, delta, 0.0)
    return delta.square().sum(), batch.valid.sum().to(torch.float32)


def mdb_parts(ev: TrajEval, batch: RolloutBatch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modified DB (Deleu et al. 2022) for envs whose every state is
    terminal, as (residual sum, count of non-stop transitions).  For a
    transition s -> s' that is not the stop action:
    R(s) P_F(s'|s) P_F(stop|s') = R(s') P_B(s|s') P_F(stop|s).  The stop
    transition moves s to its stopped copy and is told by done[t+1]."""
    lr = batch.log_r_state
    delta = (lr[:-1] + ev.log_pf + ev.log_pf_stop[1:]
             - lr[1:] - ev.log_pb - ev.log_pf_stop[:-1])
    real = batch.valid & ~batch.done[1:]
    delta = torch.where(real, delta, 0.0)
    return delta.square().sum(), real.sum().to(torch.float32)


PartsFn = Callable[[TrajEval, RolloutBatch, Dict, object],
                   Tuple[torch.Tensor, torch.Tensor]]

#: objective name -> ``parts(ev, batch, params, cfg) -> (sum, weight)``,
#: the additive form of ``repro.core.objectives.OBJECTIVE_PARTS``
OBJECTIVE_PARTS: Dict[str, PartsFn] = {
    "tb": lambda ev, batch, params, cfg: tb_parts(ev, batch,
                                                  params["log_z"]),
    "db": lambda ev, batch, params, cfg: db_parts(ev, batch),
    "subtb": lambda ev, batch, params, cfg: subtb_parts(ev, batch,
                                                        cfg.subtb_lambda),
    "fldb": lambda ev, batch, params, cfg: fldb_parts(ev, batch),
    "mdb": lambda ev, batch, params, cfg: mdb_parts(ev, batch),
}

#: objectives of the JAX package that the port does not have yet
NOT_PORTED: Tuple[str, ...] = ()


def objective_parts(name: str) -> PartsFn:
    """The parts function of objective ``name``; raises on the JAX
    package's objectives that are not ported yet, and on unknown names."""
    if name in OBJECTIVE_PARTS:
        return OBJECTIVE_PARTS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"objective {name!r} is not ported yet; "
                                  f"ported: {sorted(OBJECTIVE_PARTS)}")
    raise KeyError(f"unknown objective {name!r}")
