"""Bit-sequence environment (port of ``repro.envs.bitseq``).

A length-n bit string is split into L = n/k words of k bits.  The initial
state has all L positions empty (token m = 2^k); each forward action picks
an empty position and writes one of m words: action = position * m + word.
Terminal after exactly L steps.  A backward action empties one filled
position.  The reward is
:class:`repro_torch.rewards.bitseq.BitSeqRewardModule`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..rewards.bitseq import BitSeqRewardModule
from .base import Environment, flat_index_of_tokens, tokens_of_flat_index


@dataclasses.dataclass(frozen=True)
class BitSeqState:
    tokens: torch.Tensor   # (B, L) int32 in [0, m]; m == empty
    steps: torch.Tensor    # (B,) int32


@dataclasses.dataclass(frozen=True)
class BitSeqParams:
    reward_params: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.reward_params["mode_words"].device


class BitSeqEnvironment(Environment):
    """Non-autoregressive bit-sequence generation."""

    supports_incremental_obs = True

    def __init__(self, n: int = 120, k: int = 8, beta: float = 3.0,
                 num_modes: int = 60, seed: int = 0):
        if n % k:
            raise ValueError(f"n={n} must be a multiple of k={k}")
        self.n, self.k = n, k
        self.L = n // k
        self.m = 2 ** k
        self.empty = self.m
        self.reward_module = BitSeqRewardModule(
            word_bits=k, length=self.L, beta=beta, num_modes=num_modes,
            seed=seed)
        self.action_dim = self.L * self.m
        self.backward_action_dim = self.L      # empty one position
        self.max_steps = self.L
        self.vocab_size = self.m + 1   # + the empty token

    def init(self, device: DeviceLike = None) -> BitSeqParams:
        return BitSeqParams(
            reward_params=self.reward_module.init(resolve_device(device)))

    def reset(self, num_envs: int, params: BitSeqParams
              ) -> Tuple[torch.Tensor, BitSeqState]:
        dev = params.device
        state = BitSeqState(
            tokens=torch.full((num_envs, self.L), self.empty,
                              dtype=torch.int32, device=dev),
            steps=torch.zeros(num_envs, dtype=torch.int32, device=dev))
        return self.observe(state, params), state

    def _forward(self, state: BitSeqState, action: torch.Tensor,
                 params: BitSeqParams) -> BitSeqState:
        action = action.long()
        rows = torch.arange(action.shape[0], device=action.device)
        # out of place: under a seed plan's vmap the written values carry
        # the seed axis while the reset state does not
        tokens = state.tokens.index_put(
            (rows, action // self.m), (action % self.m).to(torch.int32))
        return BitSeqState(tokens=tokens, steps=state.steps + 1)

    def _backward(self, state: BitSeqState, action: torch.Tensor,
                  params: BitSeqParams) -> BitSeqState:
        rows = torch.arange(action.shape[0], device=action.device)
        # a device tensor: a Python number is copied from the host
        tokens = state.tokens.index_put(
            (rows, action.long()), torch.full_like(state.steps, self.empty))
        return BitSeqState(tokens=tokens,
                           steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: BitSeqState,
                    params: BitSeqParams) -> torch.Tensor:
        return state.steps >= self.L

    def log_reward(self, state: BitSeqState,
                   params: BitSeqParams) -> torch.Tensor:
        return self.reward_module.log_reward(state.tokens,
                                             params.reward_params)

    def observe(self, state: BitSeqState,
                params: BitSeqParams) -> torch.Tensor:
        return state.tokens

    def forward_mask(self, state: BitSeqState,
                     params: BitSeqParams) -> torch.Tensor:
        empty = state.tokens == self.empty                   # (B, L)
        return empty.repeat_interleave(self.m, dim=-1)       # (B, L*m)

    def backward_mask(self, state: BitSeqState,
                      params: BitSeqParams) -> torch.Tensor:
        return state.tokens != self.empty                    # (B, L)

    def get_backward_action(self, state: BitSeqState, action: torch.Tensor,
                            next_state: BitSeqState,
                            params: BitSeqParams) -> torch.Tensor:
        return action // self.m

    def get_forward_action(self, state: BitSeqState,
                           bwd_action: torch.Tensor, prev_state: BitSeqState,
                           params: BitSeqParams) -> torch.Tensor:
        rows = torch.arange(bwd_action.shape[0], device=bwd_action.device)
        pos = bwd_action.long()
        return pos * self.m + state.tokens[rows, pos].long()

    def terminal_state_from_words(self, words: torch.Tensor) -> BitSeqState:
        """The terminal states holding the (B, L) word sequences."""
        return BitSeqState(
            tokens=words.to(torch.int32),
            steps=torch.full((words.shape[0],), self.L, dtype=torch.int32,
                             device=words.device))

    # -- enumeration (small instances; RewardCache, exact targets) ----------
    @property
    def num_terminal_states(self) -> int:
        return self.m ** self.L

    def flatten_index(self, tokens: torch.Tensor) -> torch.Tensor:
        """Base-m flat index of full word sequences, the order of
        :meth:`true_log_rewards`."""
        return flat_index_of_tokens(tokens, self.m, self.L)

    def flat_terminal_index(self, state: BitSeqState,
                            params: BitSeqParams) -> torch.Tensor:
        """(B,) flat index of (terminal) states; empty tokens appear only
        in non-terminal states, whose reward is masked, and are clamped
        into range."""
        return self.flatten_index(torch.clamp(state.tokens, 0, self.m - 1))

    def terminal_state_from_flat_index(self, idx: torch.Tensor
                                       ) -> BitSeqState:
        return self.terminal_state_from_words(
            tokens_of_flat_index(idx, self.m, self.L))

    def true_log_rewards(self, params: BitSeqParams,
                         max_states: int = 1 << 22) -> torch.Tensor:
        """log R over all m^L terminal words (flat base-m C-order), made on
        the params' device; more than ``max_states`` raises, as in JAX."""
        num = self.m ** self.L
        if num > max_states:
            raise ValueError(
                f"bitseq has {num} terminal states > {max_states}; "
                "exact target is only available for small instances")
        words = tokens_of_flat_index(
            torch.arange(num, device=params.device), self.m, self.L)
        return self.reward_module.log_reward(words, params.reward_params)

    def true_distribution(self, params: BitSeqParams,
                          max_states: int = 1 << 22) -> torch.Tensor:
        return torch.softmax(self.true_log_rewards(params, max_states), -1)

    def observe_last(self, state: BitSeqState, params: BitSeqParams,
                     last_action: torch.Tensor):
        """The written position is not recoverable from the state alone, so
        the caller passes the forward action that produced ``state``.
        Returns ``(token, position, length)``, each (B,) int32."""
        pos = (last_action.long() // self.m)
        rows = torch.arange(pos.shape[0], device=pos.device)
        return (state.tokens[rows, pos], pos.to(torch.int32),
                state.steps)
