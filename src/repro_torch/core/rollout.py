"""Cached forward rollouts (port of the KV-cache categorical branch of
``repro.core.rollout.forward_rollout``).

Each step appends the token the previous step added to the policy's KV
cache and samples the next action, so a rollout never re-encodes the
sequence.  Two branches, as in the JAX package:

- ``exploration_eps=None`` (statically zero, serving): one fused call,
  ``policy.sample_cached`` (the decode-step kernel on CUDA).  This is the
  serving engine's parity target: a request's samples are, token for
  token, those of ``forward_rollout(seed, ...)`` over the same noise.
- ``exploration_eps`` a number (training; JAX's traced epsilon, which
  turns the fused step off): ``policy.apply_cached`` (cache queries through
  the decode-attention kernel on CUDA) then epsilon-uniform
  ``sample_masked`` over a :class:`StepNoise`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..envs.base import Environment
from .types import (NoiseSource, StepNoiseSource, hash_gumbel,
                    hash_step_noise, sample_masked)


@dataclasses.dataclass(frozen=True)
class RolloutBatch:
    """Time-major trajectory batch; T = number of steps.

    obs         (T+1, B, ...)  observation of state t
    fwd_mask    (T+1, B, A)    legal forward actions at state t
    bwd_mask    (T+1, B, Ab)   legal backward actions at state t
    actions     (T, B)         forward action applied at state t
    bwd_actions (T, B)         the backward action that undoes actions[t]
    valid       (T, B)         transition t is real (source not terminal)
    done        (T+1, B)       state t is terminal
    log_reward  (B,)           terminal log-reward
    log_r_state (T+1, B)       log R(s_t) of all-states-terminal envs, else 0
    energy      (T+1, B)       forward-looking energy E(s_t), else 0
    log_pf_beh  (T, B)         log P_F of the sampled actions (0 past done)
    """
    obs: torch.Tensor
    fwd_mask: torch.Tensor
    bwd_mask: torch.Tensor
    actions: torch.Tensor
    bwd_actions: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor
    log_reward: torch.Tensor
    log_r_state: torch.Tensor
    energy: torch.Tensor
    log_pf_beh: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.actions.shape[0]


@torch.no_grad()
def forward_rollout(seed: int, env: Environment, env_params, policy,
                    num_envs: int, *,
                    noise: Union[NoiseSource, StepNoiseSource, None] = None,
                    logit_temp: Optional[float] = None,
                    exploration_eps: Optional[float] = None) -> RolloutBatch:
    """Sample ``num_envs`` trajectories of ``env.max_steps`` steps on the
    device of ``env_params``.  Row i's noise at step t is
    ``noise(seed, i, t, A)``: a (B, A) Gumbel tensor on the fused branch
    (``exploration_eps=None``, default :func:`hash_gumbel`), a
    :class:`StepNoise` on the exploring one (default
    :func:`hash_step_noise`).  ``seed`` may use 64 bits.  ``logit_temp``
    scales the forward logits (a tempered policy, as the serving engine's
    per-lane temperature); the exploring branch does not take it, as
    training does not."""
    explore = exploration_eps is not None
    if explore and logit_temp is not None:
        raise ValueError("forward_rollout: logit_temp is for the fused "
                         "(exploration_eps=None) branch only")
    if noise is None:
        noise = hash_step_noise if explore else hash_gumbel
    T = env.max_steps
    obs0, state = env.reset(num_envs, env_params)
    dev = obs0.device
    A = env.action_dim
    ids = torch.arange(num_envs, dtype=torch.int64, device=dev)
    seeds = torch.full((num_envs,), int(seed), dtype=torch.int64, device=dev)
    cache = policy.cache_init(num_envs)
    temp = None if logit_temp is None else torch.full(
        (num_envs,), float(logit_temp), dtype=torch.float32, device=dev)
    prev = torch.zeros(num_envs, dtype=torch.int64, device=dev)
    zeros = torch.zeros(num_envs, dtype=torch.float32, device=dev)
    ys = {k: [] for k in ("obs", "fwd_mask", "bwd_mask", "actions",
                          "bwd_actions", "valid", "done", "log_r",
                          "log_pf")}
    for t in range(T):
        obs = env.observe(state, env_params)
        fmask = env.forward_mask(state, env_params)
        bmask = env.backward_mask(state, env_params)
        was_done = env.is_terminal(state, env_params)
        # terminal rows keep a legal dummy action
        safe_mask = fmask | was_done[:, None]
        token, pos, length = env.observe_last(state, env_params, prev)
        step_t = torch.full_like(ids, t)
        if explore:
            n = noise(seeds, ids, step_t, A)
            out, cache = policy.apply_cached(cache, token, pos, length,
                                             step=t)
            actions, log_pf = sample_masked(
                out["logits"], safe_mask, n.gumbel, eps=exploration_eps,
                gumbel_u=n.gumbel_u, explore_u=n.explore_u)
        else:
            actions, log_pf, _, cache = policy.sample_cached(
                cache, token, pos, length, noise(seeds, ids, step_t, A),
                safe_mask, step=t, logit_temp=temp)
            actions = actions.long()
        _, new_state, log_r, _ = env.step(state, actions, env_params)
        for k, v in (("obs", obs), ("fwd_mask", fmask), ("bwd_mask", bmask),
                     ("actions", actions),
                     ("bwd_actions", env.get_backward_action(
                         state, actions, new_state, env_params)),
                     ("valid", ~was_done), ("done", was_done),
                     ("log_r", log_r),
                     ("log_pf", torch.where(was_done, 0.0, log_pf))):
            ys[k].append(v)
        state = new_state
        prev = actions
    # no ported env has per-state rewards or energies: both are zeros
    return RolloutBatch(
        obs=torch.stack(ys["obs"] + [env.observe(state, env_params)]),
        fwd_mask=torch.stack(ys["fwd_mask"]
                             + [env.forward_mask(state, env_params)]),
        bwd_mask=torch.stack(ys["bwd_mask"]
                             + [env.backward_mask(state, env_params)]),
        actions=torch.stack(ys["actions"]),
        bwd_actions=torch.stack(ys["bwd_actions"]),
        valid=torch.stack(ys["valid"]),
        done=torch.stack(ys["done"] + [env.is_terminal(state, env_params)]),
        log_reward=torch.stack(ys["log_r"]).sum(0),
        log_r_state=zeros.expand(T + 1, num_envs).clone(),
        energy=zeros.expand(T + 1, num_envs).clone(),
        log_pf_beh=torch.stack(ys["log_pf"]))
