"""Continuously batched sampling engine (port of ``repro.serve.engine``,
single device).

One engine owns a pool of ``num_lanes`` lanes, each carrying its own env
state, KV cache rows, noise coordinates (request seed, sample index, step),
request id and temperatures.  Each block advances every lane
``steps_per_sync`` transitions; when a lane's trajectory terminates, its
sample is drained to the host and the lane refilled from the pending
queue, so variable-length requests pack into one device batch.

Parity contract: sample ``i`` of a request with seed ``s`` draws its step-t
noise from ``noise(s, i, t)`` and every per-lane operation is
row-independent (per-row cache slot, per-row masked attention, per-row env
dynamics; on CUDA one kernel block per lane).  So a request's samples equal
``forward_rollout(s, ..., num_samples)`` token for token, whatever lane
they landed on and whoever shares the pool.

Per-lane temperatures: ``logit_temp`` scales the forward logits;
``reward_beta`` is served through a :class:`RewardExponent` params layer
whose beta is a (num_lanes,) vector.

Left out of this port (see ROADMAP): execution plans and sharded pools,
request dedup, fault injection, ``resize`` and ``cancel``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..core.types import NoiseSource, hash_gumbel
from ..envs.base import Environment, select_state
from ..envs.transforms import RewardExponent, TransformedParams
from .errors import EngineFailure


@dataclasses.dataclass(frozen=True)
class LaneState:
    """Device-resident lane pool (leading dim = num_lanes).

    seed, env_id  noise coordinates: request seed, sample index
    request_id    engine-local request id; -1 = idle lane
    t             per-lane trajectory step
    log_r         accumulated terminal log-reward
    """
    env_state: Any
    cache: Dict[str, torch.Tensor]
    prev_action: torch.Tensor
    seed: torch.Tensor
    env_id: torch.Tensor
    request_id: torch.Tensor
    t: torch.Tensor
    logit_temp: torch.Tensor
    reward_beta: torch.Tensor
    log_r: torch.Tensor


class _PendingSample(NamedTuple):
    request_id: int
    env_id: int
    seed: int
    logit_temp: float
    reward_beta: float


class EngineResult(NamedTuple):
    """One completed request: ``samples[i]`` is sample i's terminal
    observation."""
    request_id: int
    samples: np.ndarray
    log_rewards: np.ndarray
    steps: np.ndarray
    latency_s: float


class SamplingEngine:
    """Sampling service over one (env, policy) pair on the device of
    ``env_params``.  ``policy`` is a
    :class:`repro_torch.core.policies.TransformerPolicy` on that device;
    the env must support the incremental-observation protocol."""

    def __init__(self, env: Environment, env_params, policy, *,
                 num_lanes: int = 16, noise: NoiseSource = hash_gumbel):
        if not env.supports_incremental_obs:
            raise ValueError(f"{type(env).__name__} does not support the "
                             "incremental-observation protocol the cached "
                             "engine needs")
        self.env = RewardExponent(env)
        self.inner_params = env_params
        self.device = env_params.device
        self.policy = policy
        self.noise = noise
        self.num_lanes = L = max(1, int(num_lanes))
        self.T = T = int(env.max_steps)
        # lane transitions per block before the host looks at the pool
        # (the JAX engine's "auto"); terminal lanes no-op, so parity does
        # not depend on it
        self.steps_per_sync = max(1, min(4, T // 2))
        self._pending: deque = deque()
        self._requests: Dict[int, dict] = {}
        self._results: Dict[int, EngineResult] = {}
        self._next_id = 0
        self._occupied = np.zeros(L, bool)
        self._undrained = None      # (newly_done, count) of the last block
        self.steps_run = 0
        self.blocks_run = 0
        self.lane = self._init_lane(L)

    def _params(self, beta: torch.Tensor) -> TransformedParams:
        return TransformedParams(inner=self.inner_params,
                                 extra={"beta": beta})

    def _init_lane(self, L: int) -> LaneState:
        dev = self.device
        ones = torch.ones(L, dtype=torch.float32, device=dev)
        zeros = torch.zeros(L, dtype=torch.int64, device=dev)
        _, state0 = self.env.reset(L, self._params(ones))
        return LaneState(
            env_state=state0, cache=self.policy.cache_init(L),
            prev_action=zeros, seed=zeros, env_id=zeros,
            request_id=torch.full((L,), -1, dtype=torch.int64, device=dev),
            t=zeros, logit_temp=ones, reward_beta=ones,
            log_r=torch.zeros(L, dtype=torch.float32, device=dev))

    # -- device work -----------------------------------------------------------
    def _lane_step(self, lane: LaneState):
        """Advance every live lane one transition; idle and terminal lanes
        hold their state (their mask is all-legal, their action unused)."""
        env = self.env
        ep = self._params(lane.reward_beta)
        state = lane.env_state
        fmask = env.forward_mask(state, ep)
        was_done = env.is_terminal(state, ep)
        live = (lane.request_id >= 0) & ~was_done
        safe_mask = fmask | ~live[:, None]
        gumbel = self.noise(lane.seed, lane.env_id,
                            lane.t.clamp(0, self.T - 1), env.action_dim)
        token, pos, length = env.observe_last(state, ep, lane.prev_action)
        actions, _, _, cache = self.policy.sample_cached(
            lane.cache, token, pos, length, gumbel, safe_mask, step=lane.t,
            logit_temp=lane.logit_temp)
        actions = actions.long()
        _, nstate, log_r, done = env.step(state, actions, ep)
        nstate = select_state(~live, state, nstate)
        new_lane = dataclasses.replace(
            lane, env_state=nstate, cache=cache,
            prev_action=torch.where(live, actions, lane.prev_action),
            t=torch.where(live, lane.t + 1, lane.t),
            log_r=lane.log_r + torch.where(live, log_r, 0.0))
        return new_lane, live & done

    @torch.no_grad()
    def _block(self, lane: LaneState):
        done_any = torch.zeros(self.num_lanes, dtype=torch.bool,
                               device=self.device)
        for _ in range(self.steps_per_sync):
            lane, newly_done = self._lane_step(lane)
            done_any |= newly_done
        return lane, done_any, done_any.sum()

    @torch.no_grad()
    def _refill(self, lane: LaneState, mask, seed, env_id, request_id,
                logit_temp, reward_beta) -> LaneState:
        """Reset the lanes under ``mask`` to fresh request state: a new reset
        state and cache row, nothing of the previous occupant survives."""
        L = self.num_lanes
        _, state0 = self.env.reset(L, self._params(lane.reward_beta))
        env_state = select_state(mask, state0, lane.env_state)
        cache0 = self.policy.cache_init(L)
        row = mask.view(1, L, *([1] * (lane.cache["k"].dim() - 2)))
        cache = {k: torch.where(row, cache0[k], lane.cache[k])
                 for k in lane.cache}
        w = lambda new, old: torch.where(mask, new, old)
        zeros = torch.zeros_like(lane.t)
        return LaneState(
            env_state=env_state, cache=cache,
            prev_action=w(zeros, lane.prev_action), seed=w(seed, lane.seed),
            env_id=w(env_id, lane.env_id),
            request_id=w(request_id, lane.request_id), t=w(zeros, lane.t),
            logit_temp=w(logit_temp, lane.logit_temp),
            reward_beta=w(reward_beta, lane.reward_beta),
            log_r=w(torch.zeros_like(lane.log_r), lane.log_r))

    # -- request intake --------------------------------------------------------
    def submit(self, *, num_samples: int = 1, seed: int = 0,
               logit_temp: float = 1.0, reward_beta: float = 1.0) -> int:
        """Queue a request for ``num_samples`` trajectories; returns its
        engine-local id.  With ``logit_temp == reward_beta == 1`` sample i
        reproduces ``forward_rollout(seed, ...)`` trajectory i."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        rid = self._next_id
        self._next_id += 1
        for i in range(num_samples):
            self._pending.append(_PendingSample(
                rid, i, int(seed), float(logit_temp), float(reward_beta)))
        self._requests[rid] = {"num_samples": int(num_samples),
                               "collected": {}, "t0": time.perf_counter()}
        return rid

    def _fill(self) -> None:
        if not self._pending:
            return
        free = np.nonzero(~self._occupied)[0]
        if free.size == 0:
            return
        L = self.num_lanes
        mask = np.zeros(L, bool)
        ints = np.zeros((3, L), np.int64)          # seed, env_id, request_id
        floats = np.ones((2, L), np.float32)       # logit_temp, reward_beta
        for b in free:
            if not self._pending:
                break
            s = self._pending.popleft()
            mask[b] = True
            ints[:, b] = (s.seed, s.env_id, s.request_id)
            floats[:, b] = (s.logit_temp, s.reward_beta)
            self._occupied[b] = True
        dev = self.device
        ints_d = torch.as_tensor(ints).to(dev)
        floats_d = torch.as_tensor(floats).to(dev)
        self.lane = self._refill(self.lane, torch.as_tensor(mask).to(dev),
                                 ints_d[0], ints_d[1], ints_d[2],
                                 floats_d[0], floats_d[1])

    def _drain_pending(self) -> int:
        """Collect the lanes the last block finished (terminal lanes hold
        their state until drained).  Costs one scalar read when nothing
        finished."""
        if self._undrained is None:
            return 0
        newly_done, cnt = self._undrained
        self._undrained = None
        count = int(cnt)
        if count == 0:
            return 0
        lane = self.lane
        order = torch.argsort((~newly_done).to(torch.int32),
                              stable=True)[:count]
        obs = self.env.observe(lane.env_state,
                               self._params(lane.reward_beta))
        obs, log_r, rid, eid, steps = (
            x.index_select(0, order).cpu().numpy()
            for x in (obs, lane.log_r, lane.request_id, lane.env_id, lane.t))
        order = order.cpu().numpy()
        bad = [int(order[i]) for i in range(count)
               if not np.isfinite(log_r[i]) or not 1 <= steps[i] <= self.T]
        if bad:
            raise EngineFailure(
                f"drained lane(s) {bad} carry malformed state "
                f"(non-finite log-reward or impossible step count)")
        now = time.perf_counter()
        for i in range(count):
            b, r = int(order[i]), int(rid[i])
            self._occupied[b] = False
            req = self._requests[r]
            req["collected"][int(eid[i])] = (obs[i], float(log_r[i]),
                                             int(steps[i]))
            if len(req["collected"]) == req["num_samples"]:
                got = [req["collected"][j] for j in range(req["num_samples"])]
                self._results[r] = EngineResult(
                    request_id=r, samples=np.stack([g[0] for g in got]),
                    log_rewards=np.asarray([g[1] for g in got], np.float32),
                    steps=np.asarray([g[2] for g in got], np.int32),
                    latency_s=now - req["t0"])
                del self._requests[r]
        return count

    # -- drive -------------------------------------------------------------------
    def step(self) -> int:
        """Drain the previous block's completions, refill free lanes, and
        launch the next block of ``steps_per_sync`` transitions; returns how
        many lanes the drain freed."""
        finished = self._drain_pending()
        self._fill()
        if not self._occupied.any():
            return finished
        self.lane, newly_done, cnt = self._block(self.lane)
        self._undrained = (newly_done, cnt)
        self.blocks_run += 1
        self.steps_run += self.steps_per_sync
        return finished

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._occupied.any())

    def take_results(self) -> Dict[int, EngineResult]:
        out, self._results = self._results, {}
        return out

    def run(self) -> Dict[int, EngineResult]:
        """Drive until every submitted request has completed; returns (and
        clears) the finished results keyed by request id."""
        budget = (len(self._pending) + int(self._occupied.sum())) \
            * (self.T + self.steps_per_sync) + self.T \
            + 2 * self.steps_per_sync
        while self.has_work:
            self.step()
            budget -= self.steps_per_sync
            if budget < 0:
                raise EngineFailure(
                    "engine failed to drain its lane pool within the "
                    "worst-case step budget")
        return self.take_results()
