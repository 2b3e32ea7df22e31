"""Sequence-generation environments (port of ``repro.envs.sequences``;
paper §B.2): TFBind8, QM9 and AMP.

- TFBind8: autoregressive, fixed length 8, vocab 4;
- QM9: prepend/append, 5 blocks from an 11-word vocabulary;
- AMP: autoregressive, variable length <= 60, vocab 20 + stop.

Tokens are int32 and the pad token is ``vocab``.  Where the JAX package
writes at an index one past the end (which JAX drops), the port clamps the
index: the row is one whose result ``step`` or ``backward_step`` throws
away.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .base import (Environment, SeqTerminal, flat_index_of_tokens,
                   tokens_of_flat_index)


@dataclasses.dataclass(frozen=True)
class SeqParams:
    """Env params of the sequence environments: the reward module's
    parameters and the device they live on."""
    reward_params: Dict[str, Any]
    device: torch.device


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


class _SeqEnvironment(Environment):
    """What the three sequence environments share: the reward seam, a
    reward module of the terminal :class:`SeqTerminal`."""

    def init(self, device: DeviceLike = None) -> SeqParams:
        dev = resolve_device(device)
        return SeqParams(reward_params=self.reward_module.init(dev),
                         device=dev)

    def log_reward(self, state, params: SeqParams) -> torch.Tensor:
        return self.reward_module.log_reward(
            self.terminal_repr(state, params), params.reward_params)

    def observe(self, state, params: SeqParams) -> torch.Tensor:
        return state.tokens

class _Enumerable:
    """The enumerable target of the fixed-length environments (TFBind8,
    QM9): every terminal sequence by its flat base-vocab index."""

    @property
    def num_terminal_states(self) -> int:
        return self.vocab ** self.length

    def flatten_index(self, tokens: torch.Tensor) -> torch.Tensor:
        """Base-vocab flat index of full sequences (the order of
        ``true_log_rewards``)."""
        return flat_index_of_tokens(tokens, self.vocab, self.length)

    def flat_terminal_index(self, state, params: SeqParams) -> torch.Tensor:
        # pad tokens appear only before the terminal; the clamp keeps the
        # index in range there
        return self.flatten_index(
            self.observe(state, params).clamp(0, self.vocab - 1))

    def terminal_state_from_flat_index(self, idx: torch.Tensor):
        return self.terminal_state_from_tokens(
            tokens_of_flat_index(idx, self.vocab, self.length))

    def true_log_rewards(self, params: SeqParams) -> torch.Tensor:
        """log R over every terminal sequence, flat base-vocab order."""
        return self.reward_module.true_log_rewards(params.reward_params)

    def true_distribution(self, params: SeqParams) -> torch.Tensor:
        return torch.softmax(self.true_log_rewards(params), 0)


# -- autoregressive, fixed length (TFBind8) ---------------------------------

@dataclasses.dataclass(frozen=True)
class SeqState:
    tokens: torch.Tensor    # (B, max_len) int32; pad = vocab
    length: torch.Tensor    # (B,) int32
    steps: torch.Tensor     # (B,) int32
    stopped: torch.Tensor   # (B,) bool (variable-length envs only)


def _empty_seq_state(num_envs: int, max_len: int, pad: int,
                     device: torch.device) -> SeqState:
    i32 = dict(dtype=torch.int32, device=device)
    return SeqState(tokens=torch.full((num_envs, max_len), pad, **i32),
                    length=torch.zeros(num_envs, **i32),
                    steps=torch.zeros(num_envs, **i32),
                    stopped=torch.zeros(num_envs, dtype=torch.bool,
                                        device=device))


class AutoregressiveEnvironment(_SeqEnvironment):
    """Fixed-length generation: the action is the next symbol.  One
    backward action, "remove the last symbol"."""

    supports_incremental_obs = True

    def __init__(self, reward_module, length: int, vocab: int):
        self.reward_module = reward_module
        self.length, self.vocab = length, vocab
        self.pad = vocab
        self.action_dim = vocab
        self.backward_action_dim = 1
        self.max_steps = length
        self.vocab_size = vocab + 1

    def reset(self, num_envs: int, params: SeqParams
              ) -> Tuple[torch.Tensor, SeqState]:
        state = _empty_seq_state(num_envs, self.length, self.pad,
                                 params.device)
        return self.observe(state, params), state

    def _forward(self, state: SeqState, action: torch.Tensor,
                 params: SeqParams) -> SeqState:
        tokens = state.tokens.clone()
        tokens[_rows(action), state.length.long().clamp(max=self.length - 1)
               ] = action.to(torch.int32)
        return SeqState(tokens=tokens, length=state.length + 1,
                        steps=state.steps + 1, stopped=state.stopped)

    def _backward(self, state: SeqState, action: torch.Tensor,
                  params: SeqParams) -> SeqState:
        tokens = state.tokens.clone()
        # at length 0 this writes the last slot, as JAX's index -1 does;
        # backward_step keeps the initial state there
        tokens[_rows(action), state.length.long() - 1] = self.pad
        return SeqState(tokens=tokens,
                        length=torch.clamp(state.length - 1, min=0),
                        steps=torch.clamp(state.steps - 1, min=0),
                        stopped=state.stopped)

    def is_terminal(self, state: SeqState, params: SeqParams
                    ) -> torch.Tensor:
        return state.length >= self.length

    def terminal_repr(self, state: SeqState, params: SeqParams
                      ) -> SeqTerminal:
        return SeqTerminal(tokens=state.tokens, length=state.length)

    def forward_mask(self, state: SeqState, params: SeqParams
                     ) -> torch.Tensor:
        ok = state.length < self.length
        return ok[:, None].expand(ok.shape[0], self.vocab)

    def backward_mask(self, state: SeqState, params: SeqParams
                      ) -> torch.Tensor:
        return (state.length > 0)[:, None]

    def get_backward_action(self, state, action, next_state, params):
        return torch.zeros_like(action)

    def get_forward_action(self, state: SeqState, bwd_action: torch.Tensor,
                           prev_state: SeqState, params: SeqParams
                           ) -> torch.Tensor:
        return state.tokens[_rows(bwd_action),
                            prev_state.length.long()].long()

    def observe_last(self, state: SeqState, params: SeqParams,
                     last_action: torch.Tensor = None):
        """``(token, position, length)`` of the newest token (position 0 and
        the pad token before the first step)."""
        idx = torch.clamp(state.length - 1, min=0)
        return state.tokens[_rows(idx), idx.long()], idx, state.length

    def terminal_state_from_tokens(self, tokens: torch.Tensor) -> SeqState:
        B, dev = tokens.shape[0], tokens.device
        full = torch.full((B,), self.length, dtype=torch.int32, device=dev)
        return SeqState(tokens=tokens.to(torch.int32), length=full,
                        steps=full.clone(),
                        stopped=torch.zeros(B, dtype=torch.bool, device=dev))


class TFBind8Environment(_Enumerable, AutoregressiveEnvironment):
    """DNA-sequence design, length 8 over {A, C, G, T} (paper §3.3)."""

    def __init__(self, reward_module=None):
        if reward_module is None:
            from ..rewards.tfbind8 import TFBind8RewardModule
            reward_module = TFBind8RewardModule()
        super().__init__(reward_module, length=8, vocab=4)


# -- variable-length autoregressive (AMP) -------------------------------------

class VariableLengthSeqEnvironment(_SeqEnvironment):
    """Generation with a stop action (the last index).  Backward actions:
    0 "remove the last symbol", 1 "un-stop".  A row at ``max_len``
    symbols may only stop, so every trajectory ends within
    ``max_len + 1`` steps."""

    supports_incremental_obs = True

    def __init__(self, reward_module, max_len: int, vocab: int,
                 min_len: int = 1):
        self.reward_module = reward_module
        self.max_len, self.min_len, self.vocab = max_len, min_len, vocab
        self.pad = vocab
        self.action_dim = vocab + 1
        self.stop_action = vocab
        self.backward_action_dim = 2
        self.max_steps = max_len + 1
        self.vocab_size = vocab + 1

    def reset(self, num_envs: int, params: SeqParams
              ) -> Tuple[torch.Tensor, SeqState]:
        state = _empty_seq_state(num_envs, self.max_len, self.pad,
                                 params.device)
        return self.observe(state, params), state

    def _forward(self, state: SeqState, action: torch.Tensor,
                 params: SeqParams) -> SeqState:
        is_stop = action == self.stop_action
        write = torch.where(is_stop, self.pad,
                            torch.clamp(action, max=self.vocab - 1))
        pos = torch.clamp(state.length.long(), max=self.max_len - 1)
        new_tokens = state.tokens.clone()
        new_tokens[_rows(action), pos] = write.to(torch.int32)
        return SeqState(
            tokens=torch.where(is_stop[:, None], state.tokens, new_tokens),
            length=torch.where(is_stop, state.length, state.length + 1),
            steps=state.steps + 1, stopped=state.stopped | is_stop)

    def _backward(self, state: SeqState, action: torch.Tensor,
                  params: SeqParams) -> SeqState:
        is_unstop = action == 1
        pos = torch.clamp(state.length.long() - 1, min=0)
        removed = state.tokens.clone()
        removed[_rows(action), pos] = self.pad
        return SeqState(
            tokens=torch.where(is_unstop[:, None], state.tokens, removed),
            length=torch.where(is_unstop, state.length,
                               torch.clamp(state.length - 1, min=0)),
            steps=torch.clamp(state.steps - 1, min=0),
            stopped=state.stopped & ~is_unstop)

    def is_terminal(self, state: SeqState, params: SeqParams
                    ) -> torch.Tensor:
        return state.stopped

    def is_initial(self, state: SeqState, params: SeqParams
                   ) -> torch.Tensor:
        return (state.length == 0) & ~state.stopped

    def terminal_repr(self, state: SeqState, params: SeqParams
                      ) -> SeqTerminal:
        return SeqTerminal(tokens=state.tokens, length=state.length)

    def forward_mask(self, state: SeqState, params: SeqParams
                     ) -> torch.Tensor:
        live = ~state.stopped
        sym_ok = live & (state.length < self.max_len)
        stop_ok = live & (state.length >= self.min_len)
        B = sym_ok.shape[0]
        return torch.cat([sym_ok[:, None].expand(B, self.vocab),
                          stop_ok[:, None]], dim=-1)

    def backward_mask(self, state: SeqState, params: SeqParams
                      ) -> torch.Tensor:
        remove_ok = ~state.stopped & (state.length > 0)
        return torch.stack([remove_ok, state.stopped], dim=-1)

    def get_backward_action(self, state, action, next_state, params):
        return (action == self.stop_action).long()

    def get_forward_action(self, state: SeqState, bwd_action: torch.Tensor,
                           prev_state: SeqState, params: SeqParams
                           ) -> torch.Tensor:
        sym = state.tokens[_rows(bwd_action),
                           torch.clamp(state.length.long() - 1, min=0)]
        return torch.where(bwd_action == 1, self.stop_action, sym.long())

    def observe_last(self, state: SeqState, params: SeqParams,
                     last_action: torch.Tensor = None):
        """As the fixed-length env's.  A stop adds no token: the length
        stays, so the step after it re-writes the newest token's K/V into
        its own slot, which the row's length no longer reaches."""
        idx = torch.clamp(state.length - 1, min=0)
        return state.tokens[_rows(idx), idx.long()], idx, state.length

    def terminal_state_from_tokens(self, tokens: torch.Tensor,
                                   lengths: torch.Tensor) -> SeqState:
        lengths = lengths.to(torch.int32)
        return SeqState(tokens=tokens.to(torch.int32), length=lengths,
                        steps=lengths + 1,
                        stopped=torch.ones(tokens.shape[0], dtype=torch.bool,
                                           device=tokens.device))


class AMPEnvironment(VariableLengthSeqEnvironment):
    """Antimicrobial-peptide design (paper §3.5 / §B.2.2): up to 60 of the
    20 amino acids, then stop; R = max(sigmoid(f(x)), r_min)."""

    def __init__(self, reward_module=None, max_len: int = 60):
        if reward_module is None:
            from ..rewards.amp import AMPRewardModule
            reward_module = AMPRewardModule(max_len=max_len)
        super().__init__(reward_module, max_len=max_len, vocab=20)


# -- prepend / append (QM9) ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrependAppendState:
    buf: torch.Tensor     # (B, 2 * length) int32; content in [start, end)
    start: torch.Tensor   # (B,) int32
    end: torch.Tensor     # (B,) int32
    steps: torch.Tensor   # (B,) int32


class PrependAppendEnvironment(_SeqEnvironment):
    """Fixed-length prepend/append generation (the QM9 formulation):
    ``2 * vocab`` actions, ``vocab`` appends then ``vocab`` prepends;
    terminal at ``length`` symbols.  Backward actions: 0 "remove the
    front", 1 "remove the back".  The observation is left-aligned, so a
    prepend moves every token: no incremental observation."""

    def __init__(self, reward_module, length: int, vocab: int):
        self.reward_module = reward_module
        self.length, self.vocab = length, vocab
        self.pad = vocab
        self.action_dim = 2 * vocab
        self.backward_action_dim = 2
        self.max_steps = length
        self.vocab_size = vocab + 1

    def reset(self, num_envs: int, params: SeqParams
              ) -> Tuple[torch.Tensor, PrependAppendState]:
        i32 = dict(dtype=torch.int32, device=params.device)
        state = PrependAppendState(
            buf=torch.full((num_envs, 2 * self.length), self.pad, **i32),
            start=torch.full((num_envs,), self.length, **i32),
            end=torch.full((num_envs,), self.length, **i32),
            steps=torch.zeros(num_envs, **i32))
        return self.observe(state, params), state

    def _forward(self, state: PrependAppendState, action: torch.Tensor,
                 params: SeqParams) -> PrependAppendState:
        word = action % self.vocab
        prepend = action >= self.vocab
        W = state.buf.shape[1]
        front = torch.clamp(state.start - 1, min=0)
        pos = torch.where(prepend, front, torch.clamp(state.end, max=W - 1))
        buf = state.buf.clone()
        buf[_rows(action), pos.long()] = word.to(torch.int32)
        return PrependAppendState(
            buf=buf, start=torch.where(prepend, front, state.start),
            end=torch.where(prepend, state.end,
                            torch.clamp(state.end + 1, max=W)),
            steps=state.steps + 1)

    def _backward(self, state: PrependAppendState, action: torch.Tensor,
                  params: SeqParams) -> PrependAppendState:
        front = action == 0
        back = torch.clamp(state.end - 1, min=0)
        pos = torch.where(front, state.start, back)
        buf = state.buf.clone()
        buf[_rows(action), pos.long().clamp(max=buf.shape[1] - 1)] = self.pad
        return PrependAppendState(
            buf=buf, start=torch.where(front, state.start + 1, state.start),
            end=torch.where(front, state.end, back),
            steps=torch.clamp(state.steps - 1, min=0))

    def seq_length(self, state: PrependAppendState) -> torch.Tensor:
        return state.end - state.start

    def is_terminal(self, state, params) -> torch.Tensor:
        return self.seq_length(state) >= self.length

    def is_initial(self, state, params) -> torch.Tensor:
        return self.seq_length(state) == 0

    def tokens_left_aligned(self, state: PrependAppendState) -> torch.Tensor:
        """(B, length) tokens from ``start`` on, pad past the length."""
        W = state.buf.shape[1]
        ar = torch.arange(self.length, device=state.buf.device)
        idx = (state.start[:, None].long() + ar[None, :]).clamp(0, W - 1)
        toks = torch.gather(state.buf, 1, idx)
        valid = ar[None] < self.seq_length(state)[:, None]
        return torch.where(valid, toks, self.pad)

    def terminal_repr(self, state, params) -> SeqTerminal:
        return SeqTerminal(tokens=self.tokens_left_aligned(state),
                           length=self.seq_length(state))

    def observe(self, state, params) -> torch.Tensor:
        return self.tokens_left_aligned(state)

    def forward_mask(self, state, params) -> torch.Tensor:
        ok = self.seq_length(state) < self.length
        return ok[:, None].expand(ok.shape[0], self.action_dim)

    def backward_mask(self, state, params) -> torch.Tensor:
        nonempty = self.seq_length(state) > 0
        return nonempty[:, None].expand(nonempty.shape[0], 2)

    def get_backward_action(self, state, action, next_state, params):
        # an append is undone by removing the back (1), a prepend by
        # removing the front (0)
        return (action < self.vocab).long()

    def get_forward_action(self, state: PrependAppendState,
                           bwd_action: torch.Tensor, prev_state,
                           params: SeqParams) -> torch.Tensor:
        rows = _rows(bwd_action)
        W = state.buf.shape[1]
        front_sym = state.buf[rows, state.start.long().clamp(max=W - 1)]
        back_sym = state.buf[rows, torch.clamp(state.end.long() - 1, min=0)]
        return torch.where(bwd_action == 0, self.vocab + front_sym.long(),
                           back_sym.long())

    def terminal_state_from_tokens(self, tokens: torch.Tensor
                                   ) -> PrependAppendState:
        B, dev = tokens.shape[0], tokens.device
        buf = torch.full((B, 2 * self.length), self.pad, dtype=torch.int32,
                         device=dev)
        buf[:, :self.length] = tokens.to(torch.int32)
        i32 = dict(dtype=torch.int32, device=dev)
        return PrependAppendState(
            buf=buf, start=torch.zeros(B, **i32),
            end=torch.full((B,), self.length, **i32),
            steps=torch.full((B,), self.length, **i32))


class QM9Environment(_Enumerable, PrependAppendEnvironment):
    """Small-molecule generation (paper §3.4): 5 blocks from 11, two
    stems; a proxy of the HOMO-LUMO gap as reward."""

    def __init__(self, reward_module=None):
        if reward_module is None:
            from ..rewards.qm9 import QM9RewardModule
            reward_module = QM9RewardModule()
        super().__init__(reward_module, length=5, vocab=11)
