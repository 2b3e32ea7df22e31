"""Environment contract of the port (port of ``repro.envs.base``).

Environments are stateless objects; every method is a function of
``(state, action, params)`` with a leading batch dimension on every state
field.  As in the JAX package:

- ``step`` on an already-terminal row is a no-op, so fixed-length rollouts
  handle variable-length episodes;
- ``step`` emits the log-reward on the rows that became terminal in that
  step and 0 on every other row.  (The JAX package skips the reward call
  when no row became terminal, behind a ``lax.cond``; the port computes it
  for the batch and keeps it on the newly terminal rows only, since asking
  whether any row finished would cost a device-to-host sync every step.
  The values are the same.)
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

EnvState = Any
EnvParams = Any


class SeqTerminal(NamedTuple):
    """Terminal representation of the sequence environments: left-aligned
    ``tokens`` (B, L) int32 (pad beyond ``length``) and ``length`` (B,)."""
    tokens: torch.Tensor
    length: torch.Tensor


def flat_index_of_tokens(tokens: torch.Tensor, base: int,
                         length: int) -> torch.Tensor:
    """Base-``base`` flat index of (..., length) token sequences, C-order:
    the order of ``flatten_index``, exact-DP targets and
    ``true_log_rewards`` tables."""
    idx = torch.zeros(tokens.shape[:-1], dtype=torch.int64,
                      device=tokens.device)
    for i in range(length):
        idx = idx * base + tokens[..., i].long()
    return idx


def tokens_of_flat_index(idx: torch.Tensor, base: int,
                         length: int) -> torch.Tensor:
    """Inverse of :func:`flat_index_of_tokens`: (...,) -> (..., length)
    int32."""
    idx = idx.long()
    return torch.stack([(idx // base ** (length - 1 - i)) % base
                        for i in range(length)], dim=-1).to(torch.int32)


def select_state(pred: torch.Tensor, old: EnvState, new: EnvState) -> EnvState:
    """Per-row select between two states of one dataclass type: ``old``
    where ``pred``, else ``new``."""
    def sel(o, n):
        p = pred.reshape(pred.shape + (1,) * (o.dim() - pred.dim()))
        return torch.where(p, o, n)

    return type(old)(**{f.name: sel(getattr(old, f.name), getattr(new, f.name))
                        for f in dataclasses.fields(old)})


class Environment(abc.ABC):
    """Vectorised GFlowNet environment."""

    #: number of forward actions
    action_dim: int
    #: number of backward actions
    backward_action_dim: int
    #: maximum trajectory length
    max_steps: int
    #: True when each forward step adds at most one observation token,
    #: exposed through :meth:`observe_last` (the KV-cache rollout path)
    supports_incremental_obs: bool = False

    @abc.abstractmethod
    def reset(self, num_envs: int, params: EnvParams
              ) -> Tuple[torch.Tensor, EnvState]:
        ...

    @abc.abstractmethod
    def _forward(self, state: EnvState, action: torch.Tensor,
                 params: EnvParams) -> EnvState:
        """Apply forward actions unconditionally (``step`` guards
        terminals)."""

    @abc.abstractmethod
    def is_terminal(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def log_reward(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def observe(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def forward_mask(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        ...

    def backward_mask(self, state: EnvState,
                      params: EnvParams) -> torch.Tensor:
        """(B, backward_action_dim) bool: legal backward actions."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement backward_mask")

    def get_backward_action(self, state: EnvState, action: torch.Tensor,
                            next_state: EnvState,
                            params: EnvParams) -> torch.Tensor:
        """The backward action that undoes forward ``action`` from
        ``state`` to ``next_state``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement get_backward_action")

    def _backward(self, state: EnvState, action: torch.Tensor,
                  params: EnvParams) -> EnvState:
        """Apply backward actions unconditionally (``backward_step`` guards
        initial states)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement backward steps")

    def get_forward_action(self, state: EnvState, bwd_action: torch.Tensor,
                           prev_state: EnvState,
                           params: EnvParams) -> torch.Tensor:
        """The forward action that maps ``prev_state`` back to ``state``
        after backward action ``bwd_action`` (inverse of
        :meth:`get_backward_action`)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement get_forward_action")

    def is_initial(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        """Default: a state with zero elapsed steps."""
        return state.steps == 0

    def observe_last(self, state: EnvState, params: EnvParams,
                     last_action: torch.Tensor):
        """``(token, position, length)`` of the observation entry the last
        forward step added; see ``repro.envs.base.Environment``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the incremental "
            "observation protocol")

    def step(self, state: EnvState, action: torch.Tensor, params: EnvParams):
        """Returns ``(obs, new_state, log_r, done)``."""
        was_done = self.is_terminal(state, params)
        new_state = select_state(was_done, state,
                                 self._forward(state, action, params))
        done = self.is_terminal(new_state, params)
        newly_done = done & ~was_done
        log_r = torch.where(newly_done,
                            self.log_reward(new_state, params).float(),
                            torch.zeros((), device=newly_done.device))
        return self.observe(new_state, params), new_state, log_r, done

    def backward_step(self, state: EnvState, action: torch.Tensor,
                      params: EnvParams):
        """One backward step; a no-op on rows already at the initial state.
        Returns ``(obs, prev_state, zeros, at_initial)``."""
        at_init = self.is_initial(state, params)
        prev = select_state(at_init, state,
                            self._backward(state, action, params))
        zeros = torch.zeros(action.shape[:1], dtype=torch.float32,
                            device=action.device)
        return (self.observe(prev, params), prev, zeros,
                self.is_initial(prev, params))
