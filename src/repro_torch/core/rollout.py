"""Forward and backward rollouts (port of ``repro.core.rollout``).

Forward rollouts take one of three branches, as in the JAX package:

- **cached, fused** (``exploration_eps=None``, a policy with KV-cache entry
  points and an env with ``supports_incremental_obs``; serving): each step
  appends the previous token to the policy's KV cache and samples in one
  call, ``policy.sample_cached`` (the decode-step kernel on CUDA).  A
  serving request's samples are, token for token, those of
  ``forward_rollout(seed, ...)`` over the same noise.
- **cached, exploring** (``exploration_eps`` a number; JAX's traced
  epsilon, which turns the fused step off): ``policy.apply_cached`` (cache
  queries through the decode-attention kernel on CUDA) then
  epsilon-uniform ``sample_masked`` over a :class:`StepNoise`.
- **uncached** (a policy without cache entry points, such as the MLP, or
  an env without ``observe_last``; JAX's ``_cache_engaged`` is False):
  ``policy.apply(obs)`` then ``sample_masked``, over a :class:`StepNoise`
  when exploring and a Gumbel tensor otherwise.

:func:`backward_rollout` samples trajectories back from given terminal
states under the uniform or the learned P_B and returns their total log
P_F and log P_B (the EUBO eval's estimator).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from ..envs.base import Environment
from .types import (NoiseSource, StepNoiseSource, hash_backward_gumbel,
                    hash_gumbel, hash_step_noise, masked_logprobs,
                    sample_masked)


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


def _cache_engaged(env: Environment, policy) -> bool:
    """The cached branches need both sides: a policy with KV-cache entry
    points (``policy.supports_cache``) and an env that reports each step's
    new observation token."""
    return (getattr(policy, "supports_cache", False)
            and getattr(env, "supports_incremental_obs", False))


@torch.no_grad()
def forward_rollout(seed: int, env: Environment, env_params, policy,
                    num_envs: int, *,
                    noise: Union[NoiseSource, StepNoiseSource, None] = None,
                    logit_temp: Optional[float] = None,
                    exploration_eps: Optional[float] = None,
                    return_final_state: bool = False):
    """Sample ``num_envs`` trajectories of ``env.max_steps`` steps on the
    device of ``env_params``.  Row i's noise at step t is
    ``noise(seed, i, t, A)``: a :class:`StepNoise` when exploring
    (``exploration_eps`` a number, default :func:`hash_step_noise`), a
    (B, A) Gumbel tensor otherwise (default :func:`hash_gumbel`).  ``seed``
    may use 64 bits.  ``logit_temp`` scales the forward logits (a tempered
    policy, as the serving engine's per-lane temperature); only the fused
    branch takes it, as only serving uses it.  Returns the batch, or
    ``(batch, final_state)`` with ``return_final_state``."""
    explore = exploration_eps is not None
    cached = _cache_engaged(env, policy)
    if logit_temp is not None and (explore or not cached):
        raise ValueError("forward_rollout: logit_temp is for the fused "
                         "(cached, exploration_eps=None) branch only")
    if noise is None:
        noise = hash_step_noise if explore else hash_gumbel
    T = env.max_steps
    obs0, state = env.reset(num_envs, env_params)
    dev = obs0.device
    A = env.action_dim
    ids = torch.arange(num_envs, dtype=torch.int64, device=dev)
    seeds = torch.full((num_envs,), int(seed), dtype=torch.int64, device=dev)
    cache = policy.cache_init(num_envs) if cached else None
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
        step_t = torch.full_like(ids, t)
        n = noise(seeds, ids, step_t, A)
        if cached:
            token, pos, length = env.observe_last(state, env_params, prev)
        if cached and not explore:
            actions, log_pf, _, cache = policy.sample_cached(
                cache, token, pos, length, n, safe_mask, step=t,
                logit_temp=temp)
            actions = actions.long()
        else:
            if cached:
                out, cache = policy.apply_cached(cache, token, pos, length,
                                                 step=t)
            else:
                out = policy.apply(obs)
            if explore:
                actions, log_pf = sample_masked(
                    out["logits"], safe_mask, n.gumbel, eps=exploration_eps,
                    gumbel_u=n.gumbel_u, explore_u=n.explore_u)
            else:
                actions, log_pf = sample_masked(out["logits"], safe_mask, n)
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
    batch = RolloutBatch(
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
    return (batch, state) if return_final_state else batch


class BackwardRollout(NamedTuple):
    log_pf: torch.Tensor     # (B,) total forward log-prob of the trajectory
    log_pb: torch.Tensor     # (B,) total backward log-prob
    batch: Optional[RolloutBatch]


@torch.no_grad()
def backward_rollout(seed: Union[int, torch.Tensor], env: Environment,
                     env_params, policy, terminal_state, *,
                     noise: Optional[NoiseSource] = None,
                     backward_policy: str = "learned",
                     collect: bool = False,
                     index: Optional[torch.Tensor] = None
                     ) -> BackwardRollout:
    """Sample tau ~ P_B(. | x) back from ``terminal_state`` for
    ``env.max_steps`` steps and return log P_F(tau) and log P_B(tau | x)
    per row (paper §B.2).

    ``backward_policy="learned"`` uses the policy's ``logits_b`` head when
    it has one and the uniform P_B otherwise; ``"uniform"`` forces the
    uniform P_B.  log P_F re-evaluates the policy at each previous state.
    Row i's draw at step t is
    ``noise(seed, index[i], t, Ab)``, a (B, Ab) Gumbel tensor (default
    :func:`hash_backward_gumbel`, a stream no forward rollout uses);
    ``seed`` is one number or a (B,) int64 tensor of per-row seeds, and
    ``index`` defaults to the row number.
    ``collect=True`` (the forward-ordered batch the replay samplers need)
    is not ported yet and raises."""
    if collect:
        raise NotImplementedError("backward_rollout(collect=True) waits for "
                                  "the replay samplers (ROADMAP.md)")
    if backward_policy not in ("learned", "uniform"):
        raise ValueError(f"unknown backward_policy {backward_policy!r}")
    if noise is None:
        noise = hash_backward_gumbel
    dev = terminal_state.steps.device
    B = terminal_state.steps.shape[0]
    ids = (torch.arange(B, dtype=torch.int64, device=dev) if index is None
           else index.to(device=dev, dtype=torch.int64))
    seeds = (seed.to(device=dev, dtype=torch.int64)
             if isinstance(seed, torch.Tensor)
             else torch.full((B,), int(seed), dtype=torch.int64, device=dev))
    acc_pf = torch.zeros(B, dtype=torch.float32, device=dev)
    acc_pb = torch.zeros(B, dtype=torch.float32, device=dev)
    state = terminal_state
    for t in range(env.max_steps):
        at_init = env.is_initial(state, env_params)
        bmask = env.backward_mask(state, env_params)
        logits_b = None
        if backward_policy == "learned":
            logits_b = policy.apply(env.observe(state, env_params)).get(
                "logits_b")
        if logits_b is None:
            logits_b = torch.zeros(bmask.shape, dtype=torch.float32,
                                   device=dev)
        bwd_a, log_pb = sample_masked(
            logits_b, bmask | at_init[:, None],
            noise(seeds, ids, torch.full_like(ids, t), bmask.shape[-1]))
        _, prev, _, _ = env.backward_step(state, bwd_a, env_params)
        live = ~at_init
        fwd_a = env.get_forward_action(state, bwd_a, prev, env_params)
        logp = masked_logprobs(
            policy.apply(env.observe(prev, env_params))["logits"],
            env.forward_mask(prev, env_params))
        log_pf = torch.gather(logp, -1, fwd_a.long()[:, None])[:, 0]
        acc_pf = acc_pf + torch.where(live, log_pf, 0.0)
        acc_pb = acc_pb + torch.where(live, log_pb, 0.0)
        state = prev
    return BackwardRollout(log_pf=acc_pf, log_pb=acc_pb, batch=None)
