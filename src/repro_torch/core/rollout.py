"""Forward and backward rollouts (port of ``repro.core.rollout``).

Forward rollouts take one of four branches, as in the JAX package:

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
- **continuous** (an env with ``continuous_actions``, the Box): the flow
  policy's ``sample`` draws float actions from its density heads over a
  :class:`FlowNoise` (default :func:`hash_flow_noise`), with the same
  masks, per-row keys and stored fields as the categorical branches.

:func:`backward_rollout` samples trajectories back from given terminal
states under the uniform or the learned P_B and returns their total log
P_F and log P_B (the EUBO eval's estimator, EB-GFN's MH test) and, with
``collect=True``, the trajectories themselves as a forward-ordered
:class:`RolloutBatch` (EB-GFN's trajectories from data; the replay
samplers' replayed terminals, which :func:`concat_rollout_batches` joins
to the fresh batch).  On a continuous env it samples through the flow
policy's ``sample_b`` and scores log P_F through its ``log_prob``.  On a
pop-only sequence env with a cached policy it answers the policy from a
KV cache filled once from the terminals (the pop-only cached backward).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from ..envs.base import Environment
from .types import (FlowNoiseSource, NoiseSource, StepNoiseSource,
                    hash_backward_gumbel, hash_flow_backward_noise,
                    hash_flow_noise, hash_gumbel, hash_step_noise,
                    masked_logprobs, sample_masked)


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


def _state_scalars(env: Environment):
    """``(log_r_state, energy)``: per-state functions ``(state, params) ->
    (B,) float32`` where the env has them (JAX's ``_state_scalars``):
    ``log_reward`` when every state is terminal (``all_states_terminal``,
    the DAG env), ``energy`` when the env defines one (the phylogenetic
    env's FLDB shaping); None where it has not, and the batch holds zeros.
    Both are device ops on the state, with no host read."""
    lrs = (lambda s, p: env.log_reward(s, p).to(torch.float32)) \
        if getattr(env, "all_states_terminal", False) else None
    return lrs, getattr(env, "energy", None)


def has_density_heads(policy) -> bool:
    """True for a flow policy (:mod:`repro_torch.nn.flows`), which marks
    itself ``density_heads``: it samples through ``sample`` / ``sample_b``
    and is teacher-forced through ``log_prob`` / ``log_prob_b``."""
    return getattr(policy, "density_heads", False)


def _continuous(env: Environment, policy) -> bool:
    """True on an env with continuous actions, whose policy must then have
    density heads (JAX raises alike)."""
    if not getattr(env, "continuous_actions", False):
        return False
    if not has_density_heads(policy):
        raise ValueError(
            f"{type(env).__name__} has continuous actions; pass a policy "
            "with density entry points (sample / log_prob, see "
            "repro_torch.nn.flows)")
    return True


def _cache_engaged(env: Environment, policy) -> bool:
    """The cached branches need both sides: a policy with KV-cache entry
    points (``policy.supports_cache``) and an env that reports each step's
    new observation token."""
    return (getattr(policy, "supports_cache", False)
            and getattr(env, "supports_incremental_obs", False))


def has_logits_b(policy) -> bool:
    """Whether ``policy.apply`` gives a learned ``logits_b`` head, read
    from the policy before any pass (a policy that does not say is taken
    to have one).  Where it has none the learned P_B is the uniform one,
    and a backward rollout evaluates nothing for it: JAX's jit drops that
    unused pass."""
    return getattr(policy, "has_logits_b", True)


def _backward_cache(env: Environment, policy, use_cache, needs_policy: bool
                    ) -> bool:
    """Resolve ``backward_rollout``'s ``use_cache`` (``"auto"``, True or
    False) as JAX's ``_cache_engaged`` and ``backward_rollout`` do, raising
    where they raise: the pop-only cached backward engages on a policy with
    cache entry points, an env with ``supports_incremental_obs`` and
    ``incremental_pop_only``, and a rollout that evaluates the policy
    (``with_log_pf`` or a learned P_B)."""
    if use_cache not in ("auto", True, False):
        raise ValueError(f"use_cache must be 'auto', True or False; got "
                         f"{use_cache!r}")
    capable = _cache_engaged(env, policy)
    if use_cache is True and not capable:
        raise ValueError(
            "use_cache=True needs a policy with cache entry points "
            "(TransformerPolicy(..., arch='decode')) and an env with "
            f"supports_incremental_obs; got policy "
            f"{type(policy).__name__}, env={type(env).__name__}")
    cached = (capable and use_cache is not False and needs_policy
              and getattr(env, "incremental_pop_only", False))
    if use_cache is True and not cached:
        raise ValueError(
            "use_cache=True on backward_rollout needs a pop-only edit "
            "regime (env.incremental_pop_only), a policy with cache_fill, "
            "and at least one per-step policy evaluation (with_log_pf or a "
            f"learned backward policy); got env={type(env).__name__}")
    return cached


def concat_rollout_batches(a: RolloutBatch, b: RolloutBatch) -> RolloutBatch:
    """Concatenate two time-major batches along the batch axis (port of
    ``repro.core.rollout.concat_rollout_batches``): ``log_reward`` is the
    only (B,) field, every other carries time on axis 0 and the batch on
    axis 1.  The replay samplers mix fresh trajectories with replayed
    ones so."""
    return RolloutBatch(**{
        f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)],
                          dim=0 if getattr(a, f.name).dim() == 1 else 1)
        for f in dataclasses.fields(RolloutBatch)})


@torch.no_grad()
def forward_rollout(seed: Union[int, torch.Tensor], env: Environment,
                    env_params, policy, num_envs: int, *,
                    noise: Union[NoiseSource, StepNoiseSource,
                                 FlowNoiseSource, None] = None,
                    logit_temp: Optional[float] = None,
                    exploration_eps: Union[float, torch.Tensor, None] = None,
                    return_final_state: bool = False, env_offset: int = 0):
    """Sample ``num_envs`` trajectories of ``env.max_steps`` steps on the
    device of ``env_params``.  Row i's noise at step t is
    ``noise(seed, i, t, A)``: a :class:`StepNoise` when exploring
    (``exploration_eps`` a number or a 0-dim float32 tensor, default
    :func:`hash_step_noise`), a (B, A) Gumbel tensor otherwise (default
    :func:`hash_gumbel`); on a continuous env, a :class:`FlowNoise` from
    ``noise(seed, i, t, policy.noise_dims)`` (default
    :func:`hash_flow_noise`) whether exploring or not.  ``seed`` may use
    64 bits; it is a number or a 0-dim int64 tensor on the env's device
    (a training iteration's, which a CUDA graph advances without the
    host).  ``logit_temp`` scales the
    forward logits (a tempered policy, as the serving engine's per-lane
    temperature); only the fused branch takes it, as only serving uses
    it.  ``env_offset`` is the global id of row 0 (JAX's
    ``env_offset``): row i draws the noise of env ``env_offset + i``, so a
    shard of a data-parallel plan samples its rows of the single-device
    batch, on every branch.  Returns the batch, or ``(batch,
    final_state)`` with ``return_final_state``."""
    explore = exploration_eps is not None
    continuous = _continuous(env, policy)
    cached = not continuous and _cache_engaged(env, policy)
    if logit_temp is not None and (explore or not cached):
        raise ValueError("forward_rollout: logit_temp is for the fused "
                         "(cached, exploration_eps=None) branch only")
    if noise is None:
        noise = (hash_flow_noise if continuous else
                 hash_step_noise if explore else hash_gumbel)
    T = env.max_steps
    obs0, state = env.reset(num_envs, env_params)
    dev = obs0.device
    A = policy.noise_dims if continuous else env.action_dim
    ids = torch.arange(int(env_offset), int(env_offset) + num_envs,
                       dtype=torch.int64, device=dev)
    seeds = (seed.to(device=dev, dtype=torch.int64).expand(num_envs)
             if isinstance(seed, torch.Tensor)
             else torch.full((num_envs,), int(seed), dtype=torch.int64,
                             device=dev))
    cache = policy.cache_init(num_envs) if cached else None
    temp = None if logit_temp is None else torch.full(
        (num_envs,), float(logit_temp), dtype=torch.float32, device=dev)
    prev = torch.zeros(num_envs, dtype=torch.int64, device=dev)
    zeros = torch.zeros(num_envs, dtype=torch.float32, device=dev)
    scalars = dict(zip(("log_r_state", "energy"), _state_scalars(env)))
    ys = {k: [] for k in ("obs", "fwd_mask", "bwd_mask", "actions",
                          "bwd_actions", "valid", "done", "log_r",
                          "log_pf", "log_r_state", "energy")}
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
        if continuous:
            actions, log_pf = policy.sample(obs, safe_mask, n,
                                            eps=exploration_eps)
        elif cached and not explore:
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
        for k, fn in scalars.items():
            if fn is not None:
                ys[k].append(fn(state, env_params))
        state = new_state
        prev = actions

    def per_state(k):
        """(T+1, B) of state scalar ``k``, zeros where the env has none."""
        if scalars[k] is None:
            return zeros.expand(T + 1, num_envs).clone()
        return torch.stack(ys[k] + [scalars[k](state, env_params)])

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
        log_r_state=per_state("log_r_state"),
        energy=per_state("energy"),
        log_pf_beh=torch.stack(ys["log_pf"]))
    return (batch, state) if return_final_state else batch


class BackwardRollout(NamedTuple):
    log_pf: torch.Tensor     # (B,) total forward log-prob of the trajectory
    log_pb: torch.Tensor     # (B,) total backward log-prob
    batch: Optional[RolloutBatch]


@torch.no_grad()
def backward_rollout(seed: Union[int, torch.Tensor], env: Environment,
                     env_params, policy, terminal_state, *,
                     noise: Union[NoiseSource, FlowNoiseSource,
                                  None] = None,
                     backward_policy: str = "learned",
                     collect: bool = False,
                     with_log_pf: bool = True,
                     known_log_reward: Optional[torch.Tensor] = None,
                     index: Optional[torch.Tensor] = None,
                     use_cache: Union[bool, str] = "auto"
                     ) -> BackwardRollout:
    """Sample tau ~ P_B(. | x) back from ``terminal_state`` for
    ``env.max_steps`` steps and return log P_F(tau) and log P_B(tau | x)
    per row (paper §B.2).

    ``backward_policy="learned"`` uses the policy's ``logits_b`` head when
    it has one and the uniform P_B otherwise; ``"uniform"`` forces the
    uniform P_B.  log P_F re-evaluates the policy at each previous state;
    ``with_log_pf=False`` skips that, and ``log_pf`` (and the batch's
    ``log_pf_beh``) are zeros.  Row i's draw at step t is
    ``noise(seed, index[i], t, Ab)``, a (B, Ab) Gumbel tensor (default
    :func:`hash_backward_gumbel`, a stream no forward rollout uses);
    ``seed`` is one number, a 0-dim or a (B,) int64 tensor, and ``index``
    defaults to the row number.

    ``collect=True`` also returns the trajectories as a forward-ordered
    :class:`RolloutBatch` (``.batch``), as JAX builds it: a trajectory
    shorter than ``env.max_steps`` is padded at its start with no-op
    transitions at the initial state (``valid`` False there).  Its fields
    have the dtypes :func:`forward_rollout` gives them.
    ``known_log_reward`` (B,) is the batch's ``log_reward``, in place of
    the terminals' reward.

    On a continuous env the flow policy's ``sample_b`` draws over a
    :class:`FlowNoise`, ``noise(seed, index[i], t, policy.noise_dims)``
    (default :func:`hash_flow_backward_noise`), and its ``log_prob`` gives
    log P_F; ``backward_policy="uniform"`` raises there, as in JAX: a
    uniform density over continuous increments is not defined.

    The policy is evaluated only where a step reads it: log P_F at the
    previous state when ``with_log_pf``, and ``logits_b`` at the current
    state when the P_B is learned and the policy has that head
    (:func:`has_logits_b`); a rollout that needs neither evaluates
    nothing.  On a pop-only env (``incremental_pop_only``: the sequence
    envs) with a policy that has cache entry points, ``use_cache="auto"``
    (JAX's default) fills a KV cache once from the terminal sequences
    (``policy.cache_fill``) and answers each evaluation from it at the
    state's length (``policy.query_cached``: the decode-attention kernel
    on CUDA), with no append; ``use_cache=False`` re-encodes each state
    (``policy.apply``), and ``use_cache=True`` raises where the cache
    cannot engage, as JAX's does."""
    if backward_policy not in ("learned", "uniform"):
        raise ValueError(f"unknown backward_policy {backward_policy!r}")
    continuous = _continuous(env, policy)
    if continuous and backward_policy == "uniform":
        raise ValueError(
            "backward_policy='uniform' is undefined over continuous "
            "increments; the flow policy's backward density head is the "
            "only P_B here")
    if noise is None:
        noise = (hash_flow_backward_noise if continuous
                 else hash_backward_gumbel)
    dev = terminal_state.steps.device
    B = terminal_state.steps.shape[0]
    ids = (torch.arange(B, dtype=torch.int64, device=dev) if index is None
           else index.to(device=dev, dtype=torch.int64))
    seeds = (seed.to(device=dev, dtype=torch.int64).expand(B)
             if isinstance(seed, torch.Tensor)
             else torch.full((B,), int(seed), dtype=torch.int64, device=dev))
    zeros = torch.zeros(B, dtype=torch.float32, device=dev)
    acc_pf, acc_pb = zeros, zeros
    scalars = dict(zip(("log_r_state", "energy"), _state_scalars(env)))
    ys = {k: [] for k in ("obs", "fwd_mask", "bwd_mask", "done", "actions",
                          "bwd_actions", "valid", "log_pf", "log_r_state",
                          "energy")}
    learned_b = (not continuous and backward_policy == "learned"
                 and has_logits_b(policy))
    # JAX's rule decides (and raises); a cache nothing would query is not
    # filled
    cached = _backward_cache(
        env, policy, use_cache,
        needs_policy=with_log_pf or backward_policy != "uniform") \
        and (with_log_pf or learned_b)
    if cached:
        term_cache = policy.cache_fill(policy.cache_init(B),
                                       env.observe(terminal_state,
                                                   env_params))

    def policy_out(s, obs):
        """The policy's heads at states ``s``: a query of the terminal
        cache at their length, or a pass over their observation ``obs``."""
        if cached:
            return policy.query_cached(term_cache,
                                       env.observe_last(s, env_params)[2])
        return policy.apply(obs)

    state = terminal_state
    for t in range(env.max_steps):
        at_init = env.is_initial(state, env_params)
        bmask = env.backward_mask(state, env_params)
        step_t = torch.full_like(ids, t)
        if continuous:
            bwd_a, log_pb = policy.sample_b(
                env.observe(state, env_params), bmask | at_init[:, None],
                noise(seeds, ids, step_t, policy.noise_dims))
        else:
            logits_b = policy_out(state, env.observe(
                state, env_params)).get("logits_b") if learned_b else None
            if logits_b is None:
                logits_b = torch.zeros(bmask.shape, dtype=torch.float32,
                                       device=dev)
            bwd_a, log_pb = sample_masked(
                logits_b, bmask | at_init[:, None],
                noise(seeds, ids, step_t, bmask.shape[-1]))
        _, prev, _, _ = env.backward_step(state, bwd_a, env_params)
        live = ~at_init
        fwd_a = env.get_forward_action(state, bwd_a, prev, env_params)
        prev_obs = env.observe(prev, env_params)
        fmask_prev = env.forward_mask(prev, env_params)
        if with_log_pf:
            if continuous:
                log_pf = policy.log_prob(prev_obs, fwd_a)
            else:
                logp = masked_logprobs(policy_out(prev, prev_obs)["logits"],
                                       fmask_prev)
                log_pf = torch.gather(logp, -1, fwd_a.long()[:, None])[:, 0]
            log_pf = torch.where(live, log_pf, 0.0)
            acc_pf = acc_pf + log_pf
        else:
            log_pf = zeros
        acc_pb = acc_pb + torch.where(live, log_pb, 0.0)
        if collect:
            # step t visits forward time T - t: the previous state's
            # observation and forward mask, the current state's backward
            # mask, done flag and state scalars
            for k, v in (("obs", prev_obs), ("fwd_mask", fmask_prev),
                         ("bwd_mask", bmask),
                         ("done", env.is_terminal(state, env_params)),
                         ("actions", fwd_a), ("bwd_actions", bwd_a),
                         ("valid", live), ("log_pf", log_pf)):
                ys[k].append(v)
            for k, fn in scalars.items():
                if fn is not None:
                    ys[k].append(fn(state, env_params))
        state = prev
    batch = None
    if collect:
        batch = _collected_batch(env, env_params, terminal_state, state, ys,
                                 scalars, known_log_reward)
    return BackwardRollout(log_pf=acc_pf, log_pb=acc_pb, batch=batch)


def _collected_batch(env: Environment, env_params, terminal_state, state0,
                     ys, scalars, known_log_reward) -> RolloutBatch:
    """The forward-ordered batch of a collecting backward rollout (JAX's
    ``collect`` branch).  Reversed, the steps' records give forward times
    0..T-1 of the previous states' fields (``obs``, ``fwd_mask``), to which
    the terminal state adds time T, and times 1..T of the current states'
    (``bwd_mask``, ``done``, the state scalars), to which the initial
    state ``state0`` adds time 0."""
    def rev(k):
        return torch.stack(ys[k][::-1])

    def first(v, k):
        return torch.cat([v[None], rev(k)])

    def last(k, v):
        return torch.cat([rev(k), v[None]])

    def per_state(k):
        """(T+1, B) of state scalar ``k``, zeros where the env has none."""
        if scalars[k] is None:
            return torch.zeros(len(ys["valid"]) + 1,
                               terminal_state.steps.shape[0],
                               dtype=torch.float32,
                               device=terminal_state.steps.device)
        return first(scalars[k](state0, env_params), k)

    log_r = (env.log_reward(terminal_state, env_params)
             if known_log_reward is None else known_log_reward)
    return RolloutBatch(
        obs=last("obs", env.observe(terminal_state, env_params)),
        fwd_mask=last("fwd_mask", env.forward_mask(terminal_state,
                                                   env_params)),
        bwd_mask=first(env.backward_mask(state0, env_params), "bwd_mask"),
        actions=rev("actions"),
        bwd_actions=rev("bwd_actions"),
        valid=rev("valid"),
        done=first(env.is_terminal(state0, env_params), "done"),
        log_reward=log_r.to(torch.float32),
        log_r_state=per_state("log_r_state"),
        energy=per_state("energy"),
        log_pf_beh=rev("log_pf"))
