"""Hypergrid environment (port of ``repro.envs.hypergrid``; paper §3.1 /
§B.1, after Bengio et al. 2021).

A d-dimensional hypercube of side H.  Forward actions 0..d-1 increment one
coordinate (staying in the grid); the last action, d, is the stop action,
which moves the state to its terminal copy.  Backward action i decrements
coordinate i; backward action d is "un-stop".  Observations are float32
one-hots of shape (B, d·H).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..rewards.hypergrid import (EasyHypergridRewardModule,
                                 HypergridRewardModule)
from .base import Environment


@dataclasses.dataclass(frozen=True)
class HypergridState:
    pos: torch.Tensor        # (B, d) int32
    terminal: torch.Tensor   # (B,) bool: the terminal copy
    steps: torch.Tensor      # (B,) int32


@dataclasses.dataclass(frozen=True)
class HypergridParams:
    dim: int
    side: int
    reward_params: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.reward_params["side"].device


class HypergridEnvironment(Environment):

    def __init__(self, reward_module: Optional[HypergridRewardModule] = None,
                 dim: int = 4, side: int = 20):
        self.reward_module = reward_module or EasyHypergridRewardModule()
        self.dim, self.side = dim, side
        self.action_dim = dim + 1            # d increments + stop (last)
        self.stop_action = dim
        self.backward_action_dim = dim + 1   # d decrements + un-stop (last)
        self.max_steps = dim * (side - 1) + 1
        self.obs_dim = dim * side

    # -- setup -------------------------------------------------------------
    def init(self, device: DeviceLike = None) -> HypergridParams:
        return HypergridParams(
            dim=self.dim, side=self.side,
            reward_params=self.reward_module.init(resolve_device(device),
                                                  self.side))

    def reset(self, num_envs: int, params: HypergridParams
              ) -> Tuple[torch.Tensor, HypergridState]:
        dev = params.device
        state = HypergridState(
            pos=torch.zeros((num_envs, self.dim), dtype=torch.int32,
                            device=dev),
            terminal=torch.zeros((num_envs,), dtype=torch.bool, device=dev),
            steps=torch.zeros((num_envs,), dtype=torch.int32, device=dev))
        return self.observe(state, params), state

    # -- dynamics ----------------------------------------------------------
    def _onehot_dim(self, action: torch.Tensor) -> torch.Tensor:
        """(B, d) int32 one-hot of ``action``; the stop action is all
        zeros."""
        axes = torch.arange(self.dim, device=action.device)
        return (action.long()[:, None] == axes).to(torch.int32)

    def _forward(self, state: HypergridState, action: torch.Tensor,
                 params: HypergridParams) -> HypergridState:
        is_stop = action == self.dim
        pos = torch.clamp(state.pos + self._onehot_dim(action), 0,
                          self.side - 1)
        return HypergridState(pos=pos, terminal=state.terminal | is_stop,
                              steps=state.steps + 1)

    def _backward(self, state: HypergridState, action: torch.Tensor,
                  params: HypergridParams) -> HypergridState:
        is_unstop = action == self.dim
        pos = torch.clamp(state.pos - self._onehot_dim(action), 0,
                          self.side - 1)
        return HypergridState(
            pos=pos, terminal=torch.where(is_unstop, False, state.terminal),
            steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: HypergridState, params) -> torch.Tensor:
        return state.terminal

    def is_initial(self, state: HypergridState, params) -> torch.Tensor:
        return torch.all(state.pos == 0, dim=-1) & ~state.terminal

    def log_reward(self, state: HypergridState,
                   params: HypergridParams) -> torch.Tensor:
        return self.reward_module.log_reward(state.pos, params.reward_params)

    def observe(self, state: HypergridState, params) -> torch.Tensor:
        oh = torch.nn.functional.one_hot(state.pos.long(), self.side)
        return oh.to(torch.float32).reshape(state.pos.shape[0], -1)

    # -- masks ---------------------------------------------------------------
    def forward_mask(self, state: HypergridState, params) -> torch.Tensor:
        can_inc = state.pos < (self.side - 1)                 # (B, d)
        stop_ok = ~state.terminal[:, None]                    # (B, 1)
        return torch.cat([can_inc & stop_ok, stop_ok], dim=-1)

    def backward_mask(self, state: HypergridState, params) -> torch.Tensor:
        """From a terminal copy only un-stop; from a content state any
        coordinate above 0 can be decremented."""
        can_dec = (state.pos > 0) & ~state.terminal[:, None]
        return torch.cat([can_dec, state.terminal[:, None]], dim=-1)

    def get_backward_action(self, state, action, next_state, params):
        return action  # increment i <-> decrement i; stop <-> un-stop

    def get_forward_action(self, state, bwd_action, prev_state, params):
        return bwd_action

    # -- exact target ----------------------------------------------------------
    @property
    def num_terminal_states(self) -> int:
        return self.side ** self.dim

    def all_positions(self, device: DeviceLike = None) -> torch.Tensor:
        """(H^d, d) int32 grid coordinates in flat C-order
        (``meshgrid(indexing="ij")``)."""
        ax = torch.arange(self.side, dtype=torch.int32,
                          device=resolve_device(device))
        grids = torch.meshgrid(*[ax] * self.dim, indexing="ij")
        return torch.stack(grids, dim=-1).reshape(-1, self.dim)

    def true_log_rewards(self, params: HypergridParams) -> torch.Tensor:
        """log R over all H^d terminal states, flat C-order."""
        return self.reward_module.log_reward(
            self.all_positions(params.device), params.reward_params)

    def true_distribution(self, params: HypergridParams) -> torch.Tensor:
        """Exact R(x)/Z over all H^d terminal states, flat C-order."""
        return torch.softmax(self.true_log_rewards(params), dim=0)

    def flat_terminal_index(self, state: HypergridState,
                            params) -> torch.Tensor:
        """(B,) flat C-order index of (terminal) states: the RewardCache
        key, in the order of :meth:`true_log_rewards`."""
        return self.flatten_index(state.pos)

    def flatten_index(self, pos: torch.Tensor) -> torch.Tensor:
        """C-order flat index of grid coordinates, matching
        :meth:`true_distribution`'s order."""
        idx = torch.zeros(pos.shape[:-1], dtype=torch.int64,
                          device=pos.device)
        for i in range(self.dim):
            idx = idx * self.side + pos[..., i].long()
        return idx

    def terminal_state_from_flat_index(self, idx: torch.Tensor
                                       ) -> HypergridState:
        """Terminal-copy states of flat C-order indices (the inverse of
        :meth:`flatten_index`)."""
        idx = idx.long()
        pos = torch.stack([(idx // self.side ** (self.dim - 1 - i))
                           % self.side for i in range(self.dim)],
                          dim=-1).to(torch.int32)
        return HypergridState(
            pos=pos, terminal=torch.ones(idx.shape, dtype=torch.bool,
                                         device=idx.device),
            steps=pos.sum(-1, dtype=torch.int32) + 1)
