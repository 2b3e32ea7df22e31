"""Reward exponent transform (port of the part of ``repro.envs.transforms``
the serving engine uses).

:class:`RewardExponent` maps log R to beta * log R.  beta lives in a
:class:`TransformedParams` layer of the env params, so it can be a (B,)
vector, one value per row: the engine serves requests at different reward
temperatures side by side in one batch.  Its beta is not annealed over
training, so :func:`has_scheduled_reward` finds no schedule in the port's
stacks; the replay samplers read it as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .base import Environment


@dataclasses.dataclass(frozen=True)
class TransformedParams:
    """The wrapped env's params plus the transform's own tensors."""
    inner: Any
    extra: Dict[str, torch.Tensor]


class RewardExponent(Environment):
    """log R -> beta * log R; everything else is the wrapped env's."""

    #: beta is fixed (JAX's transform anneals it when given a schedule)
    scheduled = False

    def __init__(self, env: Environment):
        self.env = env
        self.action_dim = env.action_dim
        self.backward_action_dim = env.backward_action_dim
        self.max_steps = env.max_steps
        self.supports_incremental_obs = env.supports_incremental_obs
        self.incremental_pop_only = env.incremental_pop_only

    def reset(self, num_envs, params):
        return self.env.reset(num_envs, params.inner)

    def _forward(self, state, action, params):
        return self.env._forward(state, action, params.inner)

    def is_terminal(self, state, params):
        return self.env.is_terminal(state, params.inner)

    def log_reward(self, state, params):
        return params.extra["beta"] * self.env.log_reward(state, params.inner)

    def observe(self, state, params):
        return self.env.observe(state, params.inner)

    def forward_mask(self, state, params):
        return self.env.forward_mask(state, params.inner)

    def backward_mask(self, state, params):
        return self.env.backward_mask(state, params.inner)

    def get_backward_action(self, state, action, next_state, params):
        return self.env.get_backward_action(state, action, next_state,
                                            params.inner)

    def observe_last(self, state, params, last_action):
        return self.env.observe_last(state, params.inner, last_action)


def has_scheduled_reward(env: Environment) -> bool:
    """True when any layer of the transform stack anneals its reward over
    training (port of ``repro.envs.transforms.has_scheduled_reward``): a
    replay sampler then re-evaluates replayed terminals' rewards instead of
    reusing the stored ones."""
    while isinstance(env, RewardExponent):
        if env.scheduled:
            return True
        env = env.env
    return False
