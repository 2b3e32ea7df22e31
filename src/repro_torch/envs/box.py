"""Box: the 2-D continuous-state environment (port of ``repro.envs.box``;
Lahlou et al., "A Theory of Continuous Generative Flow Networks").

State is a point in the unit square plus a step counter.  A forward
action either increments both coordinates by ``u`` with per-coordinate
support ``[delta_min, min(delta_max, 1 - s_i)]``, or exits, which freezes
the point as the terminal object.  Exit is illegal at ``s0 = (0, 0)`` and
forced once a coordinate is within ``delta_min`` of the boundary.

Actions are float32 ``(B, 3) = [u_x, u_y, exit_flag]``; masks are bool
``(B, 2) = [can_increment, can_exit]`` forward and ``[step_back,
un_exit]`` backward.  Observations are ``(B, 4) = [x, y, steps /
max_steps, terminal]``, and :meth:`BoxEnvironment.obs_fields` decodes
them, so the flow policy (:mod:`repro_torch.nn.flows`) recomputes supports
from observations alone.

Every float32 operation runs in the JAX package's order, with its
constants rounded to float32 as JAX rounds its weakly typed Python
scalars, so supports, observations and masks come out bitwise.  The step
fraction divides by a float32 tensor kept on the device in the params
(CUDA turns a division by a Python number into a product with its
reciprocal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..rewards.box import BoxRewardModule
from .base import Environment

#: slack on boundary comparisons: positions are sums of float32 increments
_BOUNDARY_TOL = 1e-6


def _f32(x: float) -> float:
    """``x`` rounded to float32 (as JAX rounds a weakly typed Python
    scalar), so that an operation in either precision sees one value."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class BoxState:
    pos: torch.Tensor        # (B, 2) float32 in [0, 1]^2
    terminal: torch.Tensor   # (B,) bool: exit taken (the terminal copy)
    steps: torch.Tensor      # (B,) int32: forward steps taken (with exit)


@dataclasses.dataclass(frozen=True)
class BoxParams:
    reward_params: Dict[str, torch.Tensor]
    #: 0-dim float32 ``max_steps`` on the device: observe's divisor
    max_steps: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.max_steps.device


class BoxEnvironment(Environment):
    """Vectorised 2-D Box with increment and exit actions."""

    #: rollouts sample through the policy's density heads
    continuous_actions = True
    #: mask arms: [increment, exit] forward, [step back, un-exit] backward
    action_dim = 2
    backward_action_dim = 2
    #: stored action vector length: [u_x, u_y, exit_flag]
    action_size = 3
    obs_dim = 4

    def __init__(self, delta_min: float = 0.1, delta_max: float = 0.25):
        if not (0.0 < delta_min < delta_max <= 1.0):
            raise ValueError(
                f"need 0 < delta_min < delta_max <= 1, got "
                f"({delta_min}, {delta_max})")
        self.reward_module = BoxRewardModule()
        self.delta_min = float(delta_min)
        self.delta_max = float(delta_max)
        self.max_increments = int(
            math.floor((1.0 - delta_min) / delta_min + 1e-9)) + 1
        self.max_steps = self.max_increments + 1      # increments + exit
        self._dmin = _f32(self.delta_min)
        self._dmax = _f32(self.delta_max)
        self._reach = _f32(1.0 - self.delta_min)
        self._room = _f32(1.0 - self.delta_min + _BOUNDARY_TOL)

    # -- setup -------------------------------------------------------------
    def init(self, device: DeviceLike = None) -> BoxParams:
        dev = resolve_device(device)
        return BoxParams(
            reward_params=self.reward_module.init(dev),
            max_steps=torch.tensor(float(self.max_steps),
                                   dtype=torch.float32, device=dev))

    def reset(self, num_envs: int, params: BoxParams
              ) -> Tuple[torch.Tensor, BoxState]:
        dev = params.device
        state = BoxState(
            pos=torch.zeros((num_envs, 2), dtype=torch.float32, device=dev),
            terminal=torch.zeros((num_envs,), dtype=torch.bool, device=dev),
            steps=torch.zeros((num_envs,), dtype=torch.int32, device=dev))
        return self.observe(state, params), state

    # -- geometry (shared with nn.flows) -----------------------------------
    def forward_support(self, pos: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-coordinate forward increment interval ``[lo, hi]`` at
        ``pos`` (both shaped as ``pos``)."""
        lo = torch.full_like(pos, self._dmin)
        hi = torch.clamp(1.0 - pos, max=self._dmax)
        return lo, hi

    def backward_support(self, pos: torch.Tensor, steps: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-coordinate backward increment interval at a content state
        reached by ``steps`` increments: ``u`` is a legal increment and
        ``pos - u`` is reachable in ``steps - 1`` increments and allows one
        more.  The point ``{pos}`` at ``steps == 1``."""
        t1 = torch.clamp(steps.to(torch.float32) - 1.0, min=0.0)[..., None]
        lo = torch.maximum(torch.clamp(pos - t1 * self._dmax, min=self._dmin),
                           pos - self._reach)
        hi = torch.clamp(pos - t1 * self._dmin, max=self._dmax)
        return lo, hi

    def obs_fields(self, obs: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode observations back into ``(pos, steps int32, terminal)``;
        ``steps`` is exact (round half to even, as ``jnp.round``)."""
        steps = torch.round(obs[..., 2] * self.max_steps).to(torch.int32)
        return obs[..., :2], steps, obs[..., 3] > 0.5

    def forward_arms(self, pos: torch.Tensor, steps: torch.Tensor,
                     terminal: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(can_increment, can_exit)`` of states given by their fields."""
        live = ~terminal
        room = torch.all(pos <= self._room, dim=-1)
        return room & live, (steps >= 1) & live

    # -- dynamics ----------------------------------------------------------
    def _forward(self, state: BoxState, action: torch.Tensor,
                 params: BoxParams) -> BoxState:
        is_exit = action[:, 2] > 0.5
        delta = torch.where(is_exit[:, None], 0.0, action[:, :2])
        return BoxState(pos=torch.clamp(state.pos + delta, 0.0, 1.0),
                        terminal=state.terminal | is_exit,
                        steps=state.steps + 1)

    def _backward(self, state: BoxState, action: torch.Tensor,
                  params: BoxParams) -> BoxState:
        is_unexit = action[:, 2] > 0.5
        delta = torch.where(is_unexit[:, None], 0.0, action[:, :2])
        return BoxState(pos=torch.clamp(state.pos - delta, 0.0, 1.0),
                        terminal=state.terminal & ~is_unexit,
                        steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: BoxState, params: BoxParams) -> torch.Tensor:
        return state.terminal

    # -- observations / masks ----------------------------------------------
    def observe(self, state: BoxState, params: BoxParams) -> torch.Tensor:
        frac = state.steps.to(torch.float32) / params.max_steps
        return torch.cat([state.pos, frac[:, None],
                          state.terminal.to(torch.float32)[:, None]], dim=1)

    def forward_mask(self, state: BoxState, params: BoxParams) -> torch.Tensor:
        return torch.stack(self.forward_arms(state.pos, state.steps,
                                             state.terminal), dim=1)

    def backward_mask(self, state: BoxState,
                      params: BoxParams) -> torch.Tensor:
        can_back = ~state.terminal & (state.steps >= 1)
        return torch.stack([can_back, state.terminal], dim=1)

    # -- action correspondences: the float action is its own reverse; the
    # Dirac cases are read from the observation at density time ------------
    def get_backward_action(self, state: BoxState, action: torch.Tensor,
                            next_state: BoxState,
                            params: BoxParams) -> torch.Tensor:
        return action

    def get_forward_action(self, state: BoxState, bwd_action: torch.Tensor,
                           prev_state: BoxState,
                           params: BoxParams) -> torch.Tensor:
        return bwd_action

    # -- reward --------------------------------------------------------------
    def log_reward(self, state: BoxState, params: BoxParams) -> torch.Tensor:
        return self.reward_module.log_reward(state.pos, params.reward_params)
