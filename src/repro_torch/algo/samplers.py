"""Trajectory samplers (port of ``repro.algo.samplers``).

``sampler.build(env, env_params, policy, cfg, shard=None)`` returns
``(init_fn, sample_fn)``, as in JAX:

- ``init_fn()`` makes the sampler's carried state (None for the stateless
  samplers, a :class:`repro_torch.buffer.fifo.BufferState` for the replay
  ones), whose tensors lie on the env params' device;
- ``sample_fn(state, noise_seed, step) -> (state, RolloutBatch)`` draws
  one training batch and updates ``state`` in place, with no host read.

Each batch is drawn under ``env.update_params(env_params, step)``, as
JAX's samplers apply the hook (``repro/algo/samplers.py:92``, ``:133``,
``:211``): a scheduled reward anneals with the iteration counter.

``noise_seed`` takes the place of the JAX sampler's key: the loop passes
``train_seed(seed, step)``, so every iteration draws fresh noise.  Both
are 0-dim int64 tensors on the policy's device, read there, so that a
CUDA graph of the iteration can advance them.  The policy's parameters
are read in place, so ``sample_fn`` takes none.  JAX splits its key into
``k_roll``, ``k_sel`` and ``k_replay``; the port keys the three draws on
streams of their own (the rollout's step noise, the selection noise and
the backward rollout's Gumbels), each a noise source the caller may
replace.

``shard`` is the plan's :class:`repro_torch.algo.plan.ShardInfo`: under a
``data_parallel`` plan ``sample_fn`` runs in one rank and draws only that
shard's rows of the global batch, as JAX's do: the batch, the replay
batch and the buffer's capacity divided by ``shard.num_shards``, every
rollout keyed on ``shard.env_offset`` (global env ids), and the replay's
selection and backward rollout on ``shard.fold_shard`` of the seed, so
no two shards replay the same slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..buffer.fifo import FIFOBuffer
from ..core.rollout import (backward_rollout, concat_rollout_batches,
                            forward_rollout)
from ..core.trainer import GFNConfig, current_eps_tensor
from ..core.types import (FlowNoiseSource, NoiseSource, StepNoiseSource,
                          hash_select_noise)
from ..envs.transforms import has_scheduled_reward
from .plan import ShardInfo


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

    def __init__(self, num_envs: Optional[int] = None,
                 noise: Union[StepNoiseSource, FlowNoiseSource,
                              None] = None):
        self.num_envs = num_envs
        self.noise = noise

    def batch_size(self, cfg: GFNConfig) -> int:
        """The rows of a batch this sampler draws."""
        return self.num_envs or cfg.num_envs

    def _eps(self, cfg: GFNConfig, step: torch.Tensor) -> torch.Tensor:
        return current_eps_tensor(cfg, step)

    def build(self, env, env_params, policy, cfg: GFNConfig,
              shard: Optional[ShardInfo] = None):
        shard = shard or ShardInfo()
        B = shard.split_batch(self.num_envs or cfg.num_envs)

        def sample_fn(state, noise_seed: torch.Tensor, step: torch.Tensor):
            ep = env.update_params(env_params, step)
            return state, forward_rollout(
                noise_seed, env, ep, policy, B, noise=self.noise,
                exploration_eps=self._eps(cfg, step),
                env_offset=shard.env_offset(B))

        return (lambda: None), sample_fn


class EpsilonNoisySampler(OnPolicySampler):
    """On-policy rollouts under an epsilon-uniform behaviour policy with
    its own schedule, independent of the config's: ``eps``, annealed
    linearly to 0 over ``anneal_steps`` when that is positive.  The
    objectives score the batch under the learned policy, so this sets only
    how much off-policy exploration noise the batch carries."""
    name = "eps_noisy"

    def __init__(self, eps: float = 0.1, anneal_steps: int = 0,
                 num_envs: Optional[int] = None,
                 noise: Union[StepNoiseSource, FlowNoiseSource,
                              None] = None):
        super().__init__(num_envs=num_envs, noise=noise)
        self.eps = eps
        self.anneal_steps = anneal_steps

    def _eps(self, cfg: GFNConfig, step: torch.Tensor) -> torch.Tensor:
        """JAX's float32 schedule on the device: ``eps * (1 - clip(step /
        anneal_steps, 0, 1))``, dividing by a tensor (CUDA would multiply
        by a Python number's reciprocal)."""
        f32 = dict(dtype=torch.float32, device=step.device)
        eps = torch.full((), float(np.float32(self.eps)), **f32)
        if self.anneal_steps > 0:
            steps = torch.full((), float(self.anneal_steps), **f32)
            frac = torch.clamp(step.to(torch.float32) / steps, 0.0, 1.0)
            eps = eps * (1.0 - frac)
        return eps


class ReplaySampler:
    """FIFO replay of terminal states, rebuilt into trajectories by a
    backward rollout under the uniform P_B (JAX's ``ReplaySampler``).

    Each iteration, as ``repro/algo/samplers.py:186-235``: (1) a fresh
    rollout of ``num_envs`` (default ``cfg.num_envs``) trajectories under
    the config's epsilon, with its final states; (2) their states and
    log-rewards pushed into a :class:`FIFOBuffer` of ``capacity`` slots;
    (3) ``replay_batch`` (default ``num_envs``) items drawn back out,
    uniformly or reward-prioritized (Gumbel-max over the stored
    log-rewards / ``temperature``); (4) a collecting backward rollout from
    their states, with no log P_F pass and the stored log-reward (unless
    the reward is scheduled, :func:`has_scheduled_reward`); (5) the fresh
    and replayed batches concatenated, fresh rows first.

    Noise sources: ``noise`` the fresh rollout's (JAX's ``k_roll``; the
    rollout's default), ``select_noise(seed, index, capacity,
    prioritized)`` the selection's (``k_sel``; default
    :func:`repro_torch.core.types.hash_select_noise`) and
    ``backward_noise`` the backward rollout's (``k_replay``; the
    rollout's default, :func:`repro_torch.core.types.hash_backward_gumbel`).
    """
    name = "replay"
    #: the P_B that rebuilds trajectories from terminals
    backward_policy = "uniform"

    def __init__(self, capacity: int = 2048,
                 replay_batch: Optional[int] = None,
                 prioritized: bool = False, temperature: float = 1.0,
                 num_envs: Optional[int] = None,
                 noise: Union[StepNoiseSource, None] = None,
                 select_noise=None,
                 backward_noise: Optional[NoiseSource] = None):
        self.capacity = capacity
        self.replay_batch = replay_batch
        self.prioritized = prioritized
        self.temperature = temperature
        self.num_envs = num_envs
        self.noise = noise
        self.select_noise = select_noise or hash_select_noise
        self.backward_noise = backward_noise

    def _sizes(self, cfg: GFNConfig):
        B = self.num_envs or cfg.num_envs
        return B, self.replay_batch or self.num_envs or cfg.num_envs

    def batch_size(self, cfg: GFNConfig) -> int:
        """The rows of a batch: the fresh ones and the replayed ones."""
        return sum(self._sizes(cfg))

    def build(self, env, env_params, policy, cfg: GFNConfig,
              shard: Optional[ShardInfo] = None):
        shard = shard or ShardInfo()
        B, R = (shard.split_batch(n) for n in self._sizes(cfg))
        buf = FIFOBuffer.per_shard(self.capacity, shard.num_shards,
                                   min_batch=B)
        # a scheduled reward makes stored log-rewards stale; a constant one
        # is reused and the (possibly proxy-model) reward is not rerun
        reuse_stored_log_r = not has_scheduled_reward(env)
        # an item: one env state's fields and its log-reward
        _, state0 = env.reset(1, env_params)
        state_cls = type(state0)
        proto = {f.name: getattr(state0, f.name)[0]
                 for f in dataclasses.fields(state0)}
        proto["log_reward"] = torch.zeros((), dtype=torch.float32,
                                          device=state0.steps.device)

        def init_fn():
            return buf.init(proto)

        def sample_fn(buf_state, noise_seed: torch.Tensor,
                      step: torch.Tensor):
            dev = buf_state.size.device
            # a scheduled transform refreshes its leaves here (stored
            # priorities stay at push-time scale, as in JAX)
            ep = env.update_params(env_params, step)
            fresh, final = forward_rollout(
                noise_seed, env, ep, policy, B, noise=self.noise,
                exploration_eps=current_eps_tensor(cfg, step),
                return_final_state=True, env_offset=shard.env_offset(B))
            # the shard's own selection and backward streams
            local_seed = shard.fold_shard(noise_seed)
            items: Dict[str, torch.Tensor] = {
                f.name: getattr(final, f.name)
                for f in dataclasses.fields(final)}
            items["log_reward"] = fresh.log_reward
            buf.add_batch(buf_state, items)
            index = torch.arange(R, dtype=torch.int64, device=dev)
            sel = self.select_noise(local_seed.expand(R), index,
                                    buf.capacity, self.prioritized)
            if self.prioritized:
                temp = torch.full((), float(self.temperature),
                                  dtype=torch.float32, device=dev)
                got = buf.sample_prioritized(
                    buf_state, sel, buf_state.data["log_reward"], temp)
            else:
                got = buf.sample(buf_state, sel)
            log_r = got.pop("log_reward")
            replayed = backward_rollout(
                local_seed, env, ep, policy,
                state_cls(**got), noise=self.backward_noise,
                collect=True, backward_policy=self.backward_policy,
                known_log_reward=log_r if reuse_stored_log_r else None,
                with_log_pf=False).batch
            return buf_state, concat_rollout_batches(fresh, replayed)

        return init_fn, sample_fn


class BackwardReplaySampler(ReplaySampler):
    """Replay through the policy's learned backward head (``logits_b``;
    the uniform P_B where the policy has none): trajectories from
    P_B(tau | x), the backward-trajectory regime of Shen et al. (2023).
    On a transformer policy, which has no such head, the replay evaluates
    no policy at all."""
    name = "backward_replay"
    backward_policy = "learned"


SAMPLERS: Dict[str, type] = {
    cls.name: cls for cls in (OnPolicySampler, EpsilonNoisySampler,
                              ReplaySampler, BackwardReplaySampler)
}


def make_sampler(spec, **kwargs):
    """A sampler from a spec: an instance (returned as is) or a registry
    name of :data:`SAMPLERS`, built with ``kwargs``."""
    if not isinstance(spec, str):
        return spec
    if spec not in SAMPLERS:
        raise KeyError(f"unknown sampler {spec!r}; "
                       f"available: {sorted(SAMPLERS)}")
    return SAMPLERS[spec](**kwargs)
