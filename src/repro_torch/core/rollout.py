"""Cached forward rollouts (port of the KV-cache categorical branch of
``repro.core.rollout.forward_rollout``, exploration eps = 0).

Each step appends the token the previous step added to the policy's KV
cache and samples the next action in one fused call
(``policy.sample_cached``), so a rollout never re-encodes the sequence.
This is the serving engine's parity target: a request's samples are, token
for token, those of ``forward_rollout(seed, ...)`` over the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..envs.base import Environment
from .types import NoiseSource, hash_gumbel


@dataclasses.dataclass(frozen=True)
class RolloutBatch:
    """Time-major trajectory batch; T = number of steps.

    obs         (T+1, B, ...)  observation of state t
    fwd_mask    (T+1, B, A)    legal forward actions at state t
    actions     (T, B)         forward action applied at state t
    valid       (T, B)         transition t is real (source not terminal)
    done        (T+1, B)       state t is terminal
    log_reward  (B,)           terminal log-reward
    log_pf_beh  (T, B)         log P_F of the sampled actions (0 past done)
    """
    obs: torch.Tensor
    fwd_mask: torch.Tensor
    actions: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor
    log_reward: torch.Tensor
    log_pf_beh: torch.Tensor


@torch.no_grad()
def forward_rollout(seed: int, env: Environment, env_params, policy,
                    num_envs: int, *, noise: NoiseSource = hash_gumbel,
                    logit_temp: Optional[float] = None) -> RolloutBatch:
    """Sample ``num_envs`` trajectories of ``env.max_steps`` steps on the
    device of ``env_params``.  Row i's noise at step t is
    ``noise(seed, i, t, A)``.  ``logit_temp`` scales the forward logits (a
    tempered policy, as the serving engine's per-lane temperature)."""
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
    ys = {k: [] for k in ("obs", "fwd_mask", "actions", "valid", "done",
                          "log_r", "log_pf")}
    for t in range(T):
        obs = env.observe(state, env_params)
        fmask = env.forward_mask(state, env_params)
        was_done = env.is_terminal(state, env_params)
        # terminal rows keep a legal dummy action
        safe_mask = fmask | was_done[:, None]
        token, pos, length = env.observe_last(state, env_params, prev)
        gumbel = noise(seeds, ids, torch.full_like(ids, t), A)
        actions, log_pf, _, cache = policy.sample_cached(
            cache, token, pos, length, gumbel, safe_mask, step=t,
            logit_temp=temp)
        actions = actions.long()
        _, state, log_r, _ = env.step(state, actions, env_params)
        for k, v in (("obs", obs), ("fwd_mask", fmask), ("actions", actions),
                     ("valid", ~was_done), ("done", was_done),
                     ("log_r", log_r),
                     ("log_pf", torch.where(was_done, 0.0, log_pf))):
            ys[k].append(v)
        prev = actions
    return RolloutBatch(
        obs=torch.stack(ys["obs"] + [env.observe(state, env_params)]),
        fwd_mask=torch.stack(ys["fwd_mask"]
                             + [env.forward_mask(state, env_params)]),
        actions=torch.stack(ys["actions"]),
        valid=torch.stack(ys["valid"]),
        done=torch.stack(ys["done"] + [env.is_terminal(state, env_params)]),
        log_reward=torch.stack(ys["log_r"]).sum(0),
        log_pf_beh=torch.stack(ys["log_pf"]))
