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

from typing import Union

import torch

from ..core.rollout import forward_rollout
from ..core.trainer import GFNConfig, current_eps_tensor
from ..core.types import FlowNoiseSource, StepNoiseSource


class OnPolicySampler:
    """Fresh forward rollouts from the current policy under the config's
    epsilon-exploration schedule.  The rollout is always given the
    schedule's epsilon as a 0-dim tensor, as the JAX trainer traces it,
    even when it is 0: a categorical env then takes the exploring branch
    (``apply_cached`` + ``sample_masked``), a continuous env the flow
    policy's ``sample`` with its epsilon branch.  ``noise`` is the
    rollout's noise source: by default the rollout's own, a step-noise
    source (:func:`repro_torch.core.types.hash_step_noise`), or on a
    continuous env a flow-noise source
    (:func:`repro_torch.core.types.hash_flow_noise`)."""
    name = "on_policy"

    def __init__(self, noise: Union[StepNoiseSource, FlowNoiseSource,
                                    None] = None):
        self.noise = noise

    def build(self, env, env_params, policy, cfg: GFNConfig):
        def sample_fn(noise_seed: torch.Tensor, step: torch.Tensor):
            return forward_rollout(
                noise_seed, env, env_params, policy, cfg.num_envs,
                noise=self.noise,
                exploration_eps=current_eps_tensor(cfg, step))

        return sample_fn
