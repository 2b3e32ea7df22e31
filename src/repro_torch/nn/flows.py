"""Continuous policy heads (port of ``repro.nn.flows``): squashed
Gaussian-mixture densities over bounded increments plus an exit head, the
flow P_F / P_B pair of continuous-state GFlowNets (Lahlou et al.).

Per coordinate, a conditioner MLP gives the (logits, means, log-scales) of
a K-component Gaussian mixture squashed onto the legal increment interval:

    x = lo + (hi - lo) * sigmoid(z),      z ~ sum_k pi_k N(mu_k, sigma_k^2)

whose change of variables gives an exact log-density on ``[lo, hi]``, so
TB and DB consume these log-densities where they consumed categorical
log-probabilities.  A Bernoulli exit head decides increment against exit,
forced where the environment forces it; the two deterministic backward
transitions (un-exit, the step back to ``s0``) are Dirac, log 0.

:class:`BoxFlowPolicy` has the JAX policy's entry points:

    sample(obs, mask, noise, eps=None)  -> (action, log_pf)
    log_prob(obs, action)               -> (B,) forward log-density
    sample_b(obs, mask, noise)          -> (bwd_action, log_pb)
    log_prob_b(obs_next, bwd_action)    -> (B,) backward log-density
    log_state_flow(obs)                 -> (B,) state-flow head (DB)

Sampling takes its noise as a :class:`repro_torch.core.types.FlowNoise`
operand (torch cannot redo JAX's key stream): a caller that feeds JAX's
draws gets JAX's actions.  The density entries take the torso's output
``out`` where the caller has it, so a sampling step or a teacher-forced
batch runs the MLP once.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FlowNoise
from ..device import DeviceLike, cpu_generator, resolve_device
from .core import ParamTree, load_flat, mlp_apply, mlp_init

_LOG_2PI = 1.8378770664093453
#: finite stand-in for log(0) on an impossible exit arm
#: (``repro.envs.base.ILLEGAL_LOGPROB``)
ILLEGAL_LOGPROB = -1e9
#: numerical floors: interval widths collapse at staircase corners, and the
#: sigmoid's inverse must stay away from {0, 1}
_MIN_WIDTH = 1e-3
_EPS = 1e-6
#: head-parameter clips: means in z-space within sigmoid(+-3) of the
#: interval, scales kept from collapsing below ~0.14
_MEAN_CLIP = 3.0
_LOG_SCALE_RANGE = (-2.0, 1.0)

Mixture = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scales(log_scales: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(log_scales, *_LOG_SCALE_RANGE))


def _means(means: torch.Tensor) -> torch.Tensor:
    return torch.clamp(means, -_MEAN_CLIP, _MEAN_CLIP)


def squashed_mixture_log_prob(logits: torch.Tensor, means: torch.Tensor,
                              log_scales: torch.Tensor, x: torch.Tensor,
                              lo: torch.Tensor,
                              hi: torch.Tensor) -> torch.Tensor:
    """Exact log-density at ``x`` of the squashed Gaussian mixture on
    ``[lo, hi]``.  Mixture params are (..., K); ``x``, ``lo``, ``hi`` are
    (...,); returns (...,)."""
    width = torch.clamp(hi - lo, min=_MIN_WIDTH)
    u = torch.clamp((x - lo) / width, _EPS, 1.0 - _EPS)
    z = torch.log(u) - torch.log1p(-u)
    sig = _scales(log_scales)
    log_mix = torch.log_softmax(logits, dim=-1)
    comp = (-0.5 * ((z[..., None] - _means(means)) / sig).square()
            - torch.log(sig) - 0.5 * _LOG_2PI)
    log_pdf_z = torch.logsumexp(log_mix + comp, dim=-1)
    # |dx/dz| = width * u * (1 - u)
    return log_pdf_z - torch.log(width) - torch.log(u) - torch.log1p(-u)


def squashed_mixture_sample(gumbel: torch.Tensor, normal: torch.Tensor,
                            logits: torch.Tensor, means: torch.Tensor,
                            log_scales: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor) -> torch.Tensor:
    """One draw per leading index: the component ``argmax(logits +
    gumbel)`` (``jax.random.categorical``), its Gaussian through
    ``normal``, squashed onto ``[lo, hi]``.  Mixture params and ``gumbel``
    are (..., K); ``normal``, ``lo``, ``hi`` and the result (...,)."""
    comp = torch.argmax(logits + gumbel, dim=-1, keepdim=True)
    mu = torch.gather(_means(means), -1, comp)[..., 0]
    sig = _scales(torch.gather(log_scales, -1, comp)[..., 0])
    z = mu + sig * normal
    width = torch.clamp(hi - lo, min=_MIN_WIDTH)
    return lo + width * torch.sigmoid(z)


def _exit_logprobs(exit_logit: torch.Tensor, can_inc: torch.Tensor,
                   can_exit: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log p_exit, log (1 - p_exit))`` with the forced branches: exit is
    certain where incrementing is illegal, impossible where exit is."""
    forced_exit = ~can_inc & can_exit
    no_exit = ~can_exit
    log_pe = torch.where(forced_exit, 0.0,
                         torch.where(no_exit, ILLEGAL_LOGPROB,
                                     F.logsigmoid(exit_logit)))
    log_1me = torch.where(forced_exit, ILLEGAL_LOGPROB,
                          torch.where(no_exit, 0.0,
                                      F.logsigmoid(-exit_logit)))
    return log_pe, log_1me


class BoxFlowPolicy(nn.Module):
    """Flow policy of :class:`repro_torch.envs.box.BoxEnvironment` (port of
    ``repro.nn.flows.make_box_flow_policy``).

    One MLP torso ``torso/layer_{i}/{w,b}`` (ReLU) maps the (..., 4)
    observation to ``2 * (D * 3 * K) + 2`` outputs: the forward mixture
    block, the backward mixture block (each (D, 3K): logits, means,
    log-scales), the exit logit and the state-flow head; plus the scalar
    ``log_z`` (0 at init).  Weights are LeCun-normal from a CPU generator seeded
    ``seed``; :meth:`load_params` takes a JAX tree carried across
    (:func:`repro_torch.convert.params_from_jax`)."""

    D = 2                       # coordinates
    #: rollouts and objectives take the density entry points
    #: (:func:`repro_torch.core.rollout.has_density_heads`)
    density_heads = True

    def __init__(self, env, hidden: Sequence[int] = (128, 128),
                 num_components: int = 4, *,
                 seed: int = 0, device: DeviceLike = None,
                 requires_grad: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.env = env
        self.K = int(num_components)
        #: the last argument of a flow-noise source
        self.noise_dims = (self.D, self.K)
        out_dim = 2 * (self.D * 3 * self.K) + 2
        self.params = ParamTree({
            "torso": mlp_init(env.obs_dim, list(hidden), out_dim,
                              generator=cpu_generator(seed), device=dev),
            "log_z": torch.zeros((), device=dev),
        }, requires_grad=requires_grad)

    def load_params(self, flat: Mapping[str, torch.Tensor]) -> None:
        """Copy ``/``-keyed parameters (every leaf, same shapes) in."""
        load_flat(self.params, flat)

    def torso(self, obs: torch.Tensor) -> torch.Tensor:
        """(..., 4) observations -> (..., 2 * D * 3K + 2) head outputs."""
        return mlp_apply(self.params["torso"], obs.to(torch.float32))

    def _heads(self, out: torch.Tensor
               ) -> Tuple[Mixture, Mixture, torch.Tensor, torch.Tensor]:
        D, K = self.D, self.K
        n = D * 3 * K

        def mixture(block):     # (..., 3DK) -> three (..., D, K)
            b = block.reshape(block.shape[:-1] + (D, 3 * K))
            return b[..., :K], b[..., K:2 * K], b[..., 2 * K:]

        return (mixture(out[..., :n]), mixture(out[..., n:2 * n]),
                out[..., 2 * n], out[..., 2 * n + 1])

    def log_state_flow(self, obs: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._heads(self.torso(obs) if out is None else out)[3]

    def log_prob(self, obs: torch.Tensor, action: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(...,) log-density of forward ``action`` = [u_x, u_y, exit] at
        ``obs``: the teacher-forcing entry of the objectives."""
        env = self.env
        pos, steps, terminal = env.obs_fields(obs)
        can_inc, can_exit = env.forward_arms(pos, steps, terminal)
        (f_log, f_mu, f_ls), _, exit_logit, _ = self._heads(
            self.torso(obs) if out is None else out)
        log_pe, log_1me = _exit_logprobs(exit_logit, can_inc, can_exit)
        lo, hi = env.forward_support(pos)
        dens = squashed_mixture_log_prob(f_log, f_mu, f_ls,
                                         action[..., :2], lo, hi)
        return torch.where(action[..., 2] > 0.5, log_pe,
                           log_1me + dens.sum(-1))

    def log_prob_b(self, obs_next: torch.Tensor, bwd_action: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(...,) log-density of the backward ``bwd_action`` taken at
        ``obs_next``; un-exit and the step back to ``s0`` are Dirac, 0."""
        pos, steps, terminal = self.env.obs_fields(obs_next)
        _, (b_log, b_mu, b_ls), _, _ = self._heads(
            self.torso(obs_next) if out is None else out)
        lo, hi = self.env.backward_support(pos, steps)
        dens = squashed_mixture_log_prob(b_log, b_mu, b_ls,
                                         bwd_action[..., :2], lo, hi).sum(-1)
        return torch.where(terminal | (steps <= 1), 0.0, dens)

    def sample(self, obs: torch.Tensor, mask: torch.Tensor,
               noise: FlowNoise,
               eps: Union[float, torch.Tensor, None] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row forward draw: the exit coin, then a squashed-mixture
        increment.  ``mask`` is the rollout's (B, 2) safe mask
        ``[can_increment, can_exit]``.  ``eps`` (a number, or a 0-dim
        float32 tensor on the rows' device: JAX's traced epsilon) mixes in
        uniform draws over the legal support: a row whose explore coin is
        below it exits on a fair coin where both arms are legal (the legal
        arm otherwise) and increments uniformly.  ``eps=None`` is JAX's
        static 0.0, where that branch compiles away.  Returns ``(action
        (B, 3) float32, log_pf)``: the policy's density of the realised
        action."""
        pos = obs[..., :2]
        can_inc, can_exit = mask[:, 0], mask[:, 1]
        out = self.torso(obs)
        (f_log, f_mu, f_ls), _, exit_logit, _ = self._heads(out)
        lo, hi = self.env.forward_support(pos)
        log_pe, _ = _exit_logprobs(exit_logit, can_inc, can_exit)
        exit_draw = noise.exit_u < torch.exp(log_pe)
        u = squashed_mixture_sample(noise.gumbel, noise.normal, f_log, f_mu,
                                    f_ls, lo, hi)
        if eps is not None:
            width = torch.clamp(hi - lo, min=_MIN_WIDTH)
            u_unif = lo + width * noise.unif
            explore = noise.explore_u[:, 0] < eps
            exit_unif = torch.where(can_inc, noise.explore_u[:, 1] < 0.5,
                                    True) & can_exit
            exit_draw = torch.where(explore, exit_unif, exit_draw)
            u = torch.where(explore[:, None], u_unif, u)
        action = torch.cat([torch.where(exit_draw[:, None], 0.0, u),
                            exit_draw[:, None].to(torch.float32)], dim=1)
        return action, self.log_prob(obs, action, out)

    def sample_b(self, obs: torch.Tensor, mask: torch.Tensor,
                 noise: FlowNoise) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row backward draw at ``obs``: un-exit at terminal copies,
        the Dirac step to ``s0`` at one-increment states, a squashed-mixture
        increment removal otherwise.  ``mask`` is taken for the signature's
        sake; the branches are read from ``obs``."""
        del mask
        pos, steps, terminal = self.env.obs_fields(obs)
        out = self.torso(obs)
        _, (b_log, b_mu, b_ls), _, _ = self._heads(out)
        lo, hi = self.env.backward_support(pos, steps)
        u = squashed_mixture_sample(noise.gumbel, noise.normal, b_log, b_mu,
                                    b_ls, lo, hi)
        dirac_origin = (steps <= 1) & ~terminal
        u = torch.where(dirac_origin[:, None], pos, u)
        action = torch.cat([torch.where(terminal[:, None], 0.0, u),
                            terminal[:, None].to(torch.float32)], dim=1)
        return action, self.log_prob_b(obs, action, out)
