"""Bayesian-network structure-learning environment (port of
``repro.envs.dag``; paper §3.7 / §B.4).

A DAG is built by adding edges one at a time under an acyclicity mask kept
online: ``reach`` is the reflexive closure (reach[i, j]: a path i ~> j),
and adding u -> v is legal iff the edge is absent and reach[v, u] is
false.  On an addition the closure takes the outer product
reach[:, u] x reach[v, :] (the paper's O(d^2) "Online Mask Updates").
Every state is terminal (the stop action, last, moves it to its stopped
copy), so training uses Modified DB; log R(s) is carried in the state and
updated by the delta score (Eq. 13), a table lookup per step.

Every update is an elementwise select over the (B, d, d) or (B, d)
tensors, not an indexed write, so a step has no host read and captures in
a CUDA graph.  The closure after an edge removal is rebuilt by repeated
squaring in float32 (exact: every entry of a product is at most d), with
JAX's number of squarings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..rewards.bayesnet import BayesNetRewardModule
from .base import Environment


@dataclasses.dataclass(frozen=True)
class DAGState:
    adj: torch.Tensor        # (B, d, d) int8
    reach: torch.Tensor      # (B, d, d) bool, reflexive closure
    pa_mask: torch.Tensor    # (B, d) int32 bitmask of each node's parents
    log_r: torch.Tensor      # (B,) float32, log R(G) carried incrementally
    num_edges: torch.Tensor  # (B,) int32
    stopped: torch.Tensor    # (B,) bool
    steps: torch.Tensor      # (B,) int32


@dataclasses.dataclass(frozen=True)
class DAGParams:
    reward_params: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.reward_params["table"].device


class DAGEnvironment(Environment):

    all_states_terminal = True

    def __init__(self, reward_module: BayesNetRewardModule):
        self.reward_module = reward_module
        self.d = d = reward_module.d
        self.action_dim = d * d + 1           # edges (u*d+v) + stop (last)
        self.stop_action = d * d
        self.backward_action_dim = d * d + 1  # edge removals + un-stop
        self.max_steps = d * (d - 1) // 2 + 1

    def init(self, device: DeviceLike = None) -> DAGParams:
        return DAGParams(
            reward_params=self.reward_module.init(resolve_device(device)))

    def reset(self, num_envs: int, params: DAGParams
              ) -> Tuple[torch.Tensor, DAGState]:
        d, dev = self.d, params.device
        i32 = dict(dtype=torch.int32, device=dev)
        state = DAGState(
            adj=torch.zeros((num_envs, d, d), dtype=torch.int8, device=dev),
            reach=torch.eye(d, dtype=torch.bool, device=dev).expand(
                num_envs, d, d).clone(),
            pa_mask=torch.zeros((num_envs, d), **i32),
            log_r=params.reward_params["empty_score"].expand(
                num_envs).clone(),
            num_edges=torch.zeros((num_envs,), **i32),
            stopped=torch.zeros((num_envs,), dtype=torch.bool, device=dev),
            steps=torch.zeros((num_envs,), **i32))
        return self.observe(state, params), state

    # -- dynamics ----------------------------------------------------------
    def _edge(self, action: torch.Tensor):
        """``(edge one-hot (B, d, d) bool, u, v, node one-hot of v (B, d))``
        of ``min(action, d*d - 1)``: the stop action reads edge
        (d-1, d-1), which every caller discards."""
        d = self.d
        edge = torch.clamp(action.long(), max=d * d - 1)
        cells = torch.arange(d * d, device=action.device)
        edge_oh = (cells == edge[:, None]).reshape(-1, d, d)
        nodes = torch.arange(d, device=action.device)
        u, v = edge // d, edge % d
        return edge_oh, u, v, nodes == v[:, None]

    def _masks(self, pa_mask: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor):
        """``(old, bit)``: node v's parent bitmask and ``1 << u``, int32."""
        old = torch.gather(pa_mask, 1, v[:, None])[:, 0]
        bit = torch.bitwise_left_shift(torch.ones_like(old), u.to(torch.int32))
        return old, bit

    def _delta(self, table: torch.Tensor, v: torch.Tensor,
               hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """table[v, hi] - table[v, lo]: the delta score (Eq. 13)."""
        return table[v, hi.long()] - table[v, lo.long()]

    def _forward(self, state: DAGState, action: torch.Tensor,
                 params: DAGParams) -> DAGState:
        is_stop = action == self.stop_action
        edge_oh, u, v, v_oh = self._edge(action)
        add = edge_oh & ~is_stop[:, None, None]
        adj = state.adj + add.to(torch.int8)
        # closure: whoever reaches u now reaches whatever v reaches
        col_u = torch.gather(state.reach, 2,
                             u[:, None, None].expand(-1, self.d, 1))[..., 0]
        row_v = torch.gather(state.reach, 1,
                             v[:, None, None].expand(-1, 1, self.d))[:, 0]
        new_paths = col_u[:, :, None] & row_v[:, None, :]
        reach = state.reach | (new_paths & ~is_stop[:, None, None])
        old, bit = self._masks(state.pa_mask, u, v)
        new = torch.bitwise_or(old, bit)
        # the stop action's lookup is table[d-1, mask | 1 << (d-1)] = -inf;
        # a select (not a masked product: -inf * 0 is NaN) drops it
        delta = self._delta(params.reward_params["table"], v, new, old)
        log_r = state.log_r + torch.where(is_stop, 0.0, delta)
        pa_mask = torch.where(v_oh & ~is_stop[:, None], new[:, None],
                              state.pa_mask)
        return DAGState(adj=adj, reach=reach, pa_mask=pa_mask, log_r=log_r,
                        num_edges=state.num_edges + (~is_stop).to(torch.int32),
                        stopped=state.stopped | is_stop,
                        steps=state.steps + 1)

    def _recompute_reach(self, adj: torch.Tensor) -> torch.Tensor:
        """The closure rebuilt by repeated squaring (an edge removal cannot
        be downdated), ``max(1, bit_length(d - 1))`` squarings as in the
        JAX package, in float32: entries are path counts of at most d."""
        eye = torch.eye(self.d, dtype=torch.bool, device=adj.device)
        reach = (adj != 0) | eye
        for _ in range(max(1, (self.d - 1).bit_length())):
            r = reach.to(torch.float32)
            reach = torch.bmm(r, r) > 0
        return reach

    def _backward(self, state: DAGState, action: torch.Tensor,
                  params: DAGParams) -> DAGState:
        is_unstop = action == self.stop_action
        edge_oh, u, v, v_oh = self._edge(action)
        rm = edge_oh & ~is_unstop[:, None, None]
        adj = state.adj - rm.to(torch.int8)
        old, bit = self._masks(state.pa_mask, u, v)
        new = torch.bitwise_and(old, torch.bitwise_not(bit))
        delta = self._delta(params.reward_params["table"], v, old, new)
        log_r = state.log_r - torch.where(is_unstop, 0.0, delta)
        pa_mask = torch.where(v_oh & ~is_unstop[:, None], new[:, None],
                              state.pa_mask)
        reach = torch.where(is_unstop[:, None, None], state.reach,
                            self._recompute_reach(adj))
        return DAGState(
            adj=adj, reach=reach, pa_mask=pa_mask, log_r=log_r,
            num_edges=state.num_edges - (~is_unstop).to(torch.int32),
            stopped=state.stopped & ~is_unstop,
            steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: DAGState, params) -> torch.Tensor:
        return state.stopped

    def is_initial(self, state: DAGState, params) -> torch.Tensor:
        return (state.num_edges == 0) & ~state.stopped

    def log_reward(self, state: DAGState, params) -> torch.Tensor:
        """The incremental delta-score sum (Eq. 13); equal to the reward
        module's direct lookup of ``pa_mask``."""
        return state.log_r

    def observe(self, state: DAGState, params) -> torch.Tensor:
        return state.adj.reshape(state.adj.shape[0], -1).to(torch.float32)

    # -- masks ---------------------------------------------------------------
    def forward_mask(self, state: DAGState, params) -> torch.Tensor:
        """u -> v is legal iff absent and reach[v, u] is false (the closure
        read transposed); stop is legal until stopped."""
        B = state.adj.shape[0]
        live = ~state.stopped
        legal = (state.adj == 0) & ~state.reach.transpose(1, 2) \
            & live[:, None, None]
        return torch.cat([legal.reshape(B, -1), live[:, None]], dim=-1)

    def backward_mask(self, state: DAGState, params) -> torch.Tensor:
        B = state.adj.shape[0]
        removable = (state.adj.reshape(B, -1) > 0) & ~state.stopped[:, None]
        return torch.cat([removable, state.stopped[:, None]], dim=-1)

    def get_backward_action(self, state, action, next_state, params):
        return action  # add (u, v) <-> remove (u, v); stop <-> un-stop

    def get_forward_action(self, state, bwd_action, prev_state, params):
        return bwd_action
