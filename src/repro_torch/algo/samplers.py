"""Trajectory samplers (port of ``repro.algo.samplers``; on-policy only).

``sampler.build(env, env_params, policy, cfg)`` returns ``sample_fn(
noise_seed, step) -> RolloutBatch``.  ``noise_seed`` takes the place of
the JAX sampler's key: the loop passes ``train_seed(seed, step)``, so every
iteration draws fresh noise.  Both are 0-dim int64 tensors on the
policy's device, read there, so that a CUDA graph of the iteration can
advance them.  The policy's parameters are read in place,
so ``sample_fn`` takes none.  The JAX contract's sampler state (a replay
buffer's) has no user until a replay sampler is ported.
"""
from __future__ import annotations

import torch

from ..core.rollout import forward_rollout
from ..core.trainer import GFNConfig, current_eps_tensor
from ..core.types import StepNoiseSource, hash_step_noise


class OnPolicySampler:
    """Fresh forward rollouts from the current policy under the config's
    epsilon-exploration schedule.  The rollout always takes the exploring
    branch (``apply_cached`` + ``sample_masked``), as the JAX trainer's
    traced epsilon does, even when epsilon is 0.  ``noise`` is the
    step-noise source (default
    :func:`repro_torch.core.types.hash_step_noise`)."""
    name = "on_policy"

    def __init__(self, noise: StepNoiseSource = hash_step_noise):
        self.noise = noise

    def build(self, env, env_params, policy, cfg: GFNConfig):
        def sample_fn(noise_seed: torch.Tensor, step: torch.Tensor):
            return forward_rollout(
                noise_seed, env, env_params, policy, cfg.num_envs,
                noise=self.noise,
                exploration_eps=current_eps_tensor(cfg, step))

        return sample_fn
