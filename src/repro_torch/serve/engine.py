"""Continuously batched sampling engine (port of ``repro.serve.engine``).

One engine owns a pool of ``num_lanes`` lanes, each carrying its own env
state, KV cache rows, noise coordinates (request seed, sample index, step),
request id and temperatures.  Each block advances every lane
``steps_per_sync`` transitions; when a lane's trajectory terminates, its
sample is drained to the host and the lane refilled from the pending
queue, so variable-length requests pack into one device batch.

Two serving tiers, as in the JAX package (the registry's ``serving``
column): an env with the incremental-observation protocol and a policy
with KV-cache entry points take the fused cached step
(``policy.sample_cached``: the decode-step kernel on CUDA); every other
env is served by observing the full state at each step,
``policy.apply(env.observe(...))``, its logits scaled by the lane's
``logit_temp``, then the masked Gumbel-max draw on the lane's noise row.

Parity contract: sample ``i`` of a request with seed ``s`` draws its step-t
noise from ``noise(s, i, t)`` and every per-lane operation is
row-independent (per-row cache slot, per-row masked attention, per-row env
dynamics; on CUDA one kernel block per lane).  So a request's samples equal
``forward_rollout(s, ..., num_samples)`` token for token, whatever lane
they landed on and whoever shares the pool.

Per-lane temperatures: ``logit_temp`` scales the forward logits;
``reward_beta`` is served through a :class:`RewardExponent` params layer
whose beta is a (num_lanes,) vector.

Drain: the count of lanes a block finished is computed in the block and
read one block late (terminal lanes hold their state, so the late drain is
exact); a zero count costs that one read, otherwise the finished rows are
gathered and copied to the host.  A drained lane with a non-finite
log-reward or an impossible step count raises :class:`LanePoisoned`.

Dedup (``dedup_cache_size > 0``, the scheduler's default): requests equal
in ``(seed, num_samples, logit_temp, reward_beta)`` on one engine compute
once.  A duplicate of an in-flight request joins it as a waiter; a
duplicate of a recently completed one is answered from a bounded LRU
without touching a lane.  The key is the seed itself: the port's noise is
a function of (seed, sample, step), so the seed is the request's whole
noise stream (JAX keys on its split step keys).

Sharded lane pools: pass ``plan="data_parallel"`` (or a
:class:`repro_torch.algo.plan.DataParallelPlan`) and the pool is cut into
the plan's D shards, in this one process, as JAX's ``shard_map`` cuts it
over a mesh: shard d owns the static-shape slice ``d`` of the lanes
(:func:`repro_torch.distributed.sharding.shard_rows`) on device
``plan.serve_devices()[d]``, and each block steps and refills every shard
on its own device, with its own ``decode_step`` launch at the per-shard
lane count; the finished counts are summed across shards.  ``num_lanes``
is rounded up to a multiple of D.  Every per-lane operation is
row-independent, so the samples are bitwise the single engine's for any
shard count.  A device may repeat in the plan's list (``["cuda:0"] * 2``,
``["cpu"] * 4``, ``cuda`` beside ``cuda:0``): the shards on the
engine's device share its policy and env parameters; a shard on another
device serves from copies of both, the caller's parameters moved there.
The host-side bookkeeping (pending queue, drain, dedup) is the single
pool's, over global lane indices.  Plans with a seed axis are refused.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, NamedTuple, Union

import numpy as np
import torch

from ..core.rollout import _cache_engaged
from ..core.types import NoiseSource, hash_gumbel, sample_masked
from ..device import resolve_device
from ..distributed.sharding import shard_rows
from ..envs.base import Environment, select_state
from ..envs.transforms import RewardExponent, TransformedParams
from ..kernels.ops import _device_index
from .errors import EngineFailure, LanePoisoned


@dataclasses.dataclass(frozen=True)
class LaneState:
    """Device-resident lane pool (leading dim = num_lanes).

    cache         KV cache of the cached tier (``{}`` on the full-obs one)
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


def _same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is the current
    card, so ``cuda`` and ``cuda:0`` can be one)."""
    a, b = resolve_device(a), resolve_device(b)
    if a.type == b.type == "cuda":
        return _device_index(a) == _device_index(b)
    return a == b


def _moved(x, dev: torch.device):
    """Env params ``x`` (a dataclass of tensors, nested dicts of them and
    plain values) on ``dev``: every tensor copied there, a stored
    ``torch.device`` replaced by ``dev``, other values as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, torch.device):
        return dev
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _moved(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _moved(v, dev) for k, v in x.items()}
    return x


class _PendingSample(NamedTuple):
    request_id: int
    env_id: int
    seed: int
    logit_temp: float
    reward_beta: float


class EngineResult(NamedTuple):
    """One completed request: ``samples[i]`` is sample i's terminal
    observation.  ``dedup`` marks a result served from another request's
    computation (in-flight fan-out or LRU hit), bitwise what computing it
    would give."""
    request_id: int
    samples: np.ndarray
    log_rewards: np.ndarray
    steps: np.ndarray
    latency_s: float
    dedup: bool = False


class SamplingEngine:
    """Sampling service over one (env, policy) pair on the device of
    ``env_params``.

    ``env`` may carry a transform stack; the engine wraps one more
    :class:`RewardExponent` on top for the per-lane beta.  ``use_cache``
    (``"auto"``, True or False) picks the tier as ``forward_rollout``
    does: ``"auto"`` takes the cached one where both env and policy can.
    ``steps_per_sync`` is the transitions per block (``"auto"``:
    ``max(1, min(4, T // 2))``).  ``dedup_cache_size`` bounds the LRU of
    recent results (0 turns dedup off).  ``fault_plan`` (tests and chaos
    runs) injects failures at the ``engine_step``, ``latency`` and
    ``lane_state`` points; a failing block is retried up to
    ``max_step_retries`` times, ``retry_backoff_s`` doubling each time.
    ``noise`` is the noise source (default :func:`hash_gumbel`).  ``plan``
    (``None`` / ``"single"``, ``"data_parallel"`` or a plan) shards the
    lane pool (module docstring)."""

    def __init__(self, env: Environment, env_params, policy, *,
                 num_lanes: int = 16, use_cache: Union[bool, str] = "auto",
                 steps_per_sync: Union[int, str] = "auto",
                 plan=None, dedup_cache_size: int = 0, fault_plan=None,
                 max_step_retries: int = 2, retry_backoff_s: float = 0.02,
                 noise: NoiseSource = hash_gumbel):
        from ..algo.plan import make_plan
        self.plan = make_plan(plan if plan is not None else "single")
        if self.plan.name not in ("single", "data_parallel"):
            raise ValueError(
                f"SamplingEngine supports plan 'single' or 'data_parallel', "
                f"got {self.plan.name!r} (the lane pool has no seed axis)")
        capable = _cache_engaged(env, policy)
        if use_cache not in ("auto", True, False):
            raise ValueError(f"use_cache must be 'auto', True or False; "
                             f"got {use_cache!r}")
        if use_cache is True and not capable:
            raise ValueError(
                "use_cache=True needs a policy with KV-cache entry points "
                "(TransformerPolicy(..., arch='decode')) and an env with "
                f"supports_incremental_obs; got policy "
                f"{type(policy).__name__}, env {type(env).__name__}")
        self.cached = capable and use_cache is not False
        self.env = RewardExponent(env)
        self.inner_params = env_params
        self.device = env_params.device
        self.policy = policy
        self.noise = noise
        devs = ([self.device] if self.plan.name == "single"
                else self.plan.serve_devices())
        #: per shard: (device, policy, env params) on that device
        self._shard_ctx = [self._on_device(d) for d in devs]
        self._shards = len(devs)
        self.num_lanes = L = self._round_lanes(num_lanes)
        self.T = T = int(env.max_steps)
        # lane transitions per block before the host looks at the pool;
        # terminal lanes no-op, so parity does not depend on it
        if steps_per_sync == "auto":
            steps_per_sync = max(1, min(4, T // 2))
        self.steps_per_sync = max(1, int(steps_per_sync))
        self._pending: deque = deque()
        self._requests: Dict[int, dict] = {}
        self._results: Dict[int, EngineResult] = {}
        self._next_id = 0
        self._occupied = np.zeros(L, bool)
        self._undrained = None      # (newly_done, count) of the last block
        self.steps_run = 0
        self.blocks_run = 0
        self._faults = fault_plan
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.dedup_cache_size = max(0, int(dedup_cache_size))
        self._dedup_lru: "OrderedDict[tuple, EngineResult]" = OrderedDict()
        self._dedup_inflight: Dict[tuple, int] = {}     # ckey -> primary
        self._dedup_key_of: Dict[int, tuple] = {}       # primary -> ckey
        self._dedup_waiters: Dict[int, List[int]] = {}  # primary -> rids
        #: robustness and drain counters (the front's /stats), JAX's keys
        self.counters: Dict[str, int] = {
            "requests": 0, "completed": 0, "cancelled": 0,
            "blocks": 0, "step_retries": 0, "step_failures": 0,
            "drain_skips": 0, "drain_packs": 0, "resizes": 0,
            "dedup_hits": 0, "dedup_joins": 0, "dedup_misses": 0}
        self.lanes = self._init_lanes(L)

    def _on_device(self, dev):
        """A shard's device, policy and env params: the engine's own when
        ``dev`` is the engine's device (however it is spelled), else
        copies of them on ``dev``."""
        if _same_device(dev, self.device):
            return self.device, self.policy, self.inner_params
        dev = resolve_device(dev)
        return (dev, copy.deepcopy(self.policy).to(dev),
                _moved(self.inner_params, dev))

    def _round_lanes(self, n: int) -> int:
        """Round a lane count up to a multiple of the shard count (each
        shard owns a static-shape slice of the pool)."""
        d = self._shards
        return ((max(1, int(n)) + d - 1) // d) * d

    def _params(self, beta: torch.Tensor, d: int = 0) -> TransformedParams:
        return TransformedParams(inner=self._shard_ctx[d][2],
                                 extra={"beta": beta})

    def _init_lanes(self, L: int) -> List[LaneState]:
        """The pool of ``L`` lanes as its shards' slices."""
        return [self._init_lane(L // self._shards, d)
                for d in range(self._shards)]

    def _init_lane(self, L: int, d: int = 0) -> LaneState:
        dev, policy, _ = self._shard_ctx[d]
        ones = torch.ones(L, dtype=torch.float32, device=dev)
        zeros = torch.zeros(L, dtype=torch.int64, device=dev)
        _, state0 = self.env.reset(L, self._params(ones, d))
        return LaneState(
            env_state=state0,
            cache=policy.cache_init(L) if self.cached else {},
            prev_action=zeros, seed=zeros, env_id=zeros,
            request_id=torch.full((L,), -1, dtype=torch.int64, device=dev),
            t=zeros, logit_temp=ones, reward_beta=ones,
            log_r=torch.zeros(L, dtype=torch.float32, device=dev))

    # -- device work -----------------------------------------------------------
    def _lane_step(self, lane: LaneState, d: int = 0):
        """Advance every live lane of shard ``d`` one transition; idle and
        terminal lanes hold their state (their mask is all-legal, their
        action unused)."""
        env = self.env
        policy = self._shard_ctx[d][1]
        ep = self._params(lane.reward_beta, d)
        state = lane.env_state
        fmask = env.forward_mask(state, ep)
        was_done = env.is_terminal(state, ep)
        live = (lane.request_id >= 0) & ~was_done
        safe_mask = fmask | ~live[:, None]
        gumbel = self.noise(lane.seed, lane.env_id,
                            lane.t.clamp(0, self.T - 1), env.action_dim)
        if self.cached:
            token, pos, length = env.observe_last(state, ep, lane.prev_action)
            actions, _, _, cache = policy.sample_cached(
                lane.cache, token, pos, length, gumbel, safe_mask,
                step=lane.t, logit_temp=lane.logit_temp)
            actions = actions.long()
        else:
            out = policy.apply(env.observe(state, ep))
            logits = out["logits"] * lane.logit_temp[:, None]
            actions, _ = sample_masked(logits, safe_mask, gumbel)
            cache = lane.cache
        _, nstate, log_r, done = env.step(state, actions, ep)
        nstate = select_state(~live, state, nstate)
        new_lane = dataclasses.replace(
            lane, env_state=nstate, cache=cache,
            prev_action=torch.where(live, actions, lane.prev_action),
            t=torch.where(live, lane.t + 1, lane.t),
            log_r=lane.log_r + torch.where(live, log_r, 0.0))
        return new_lane, live & done

    @torch.no_grad()
    def _block(self, lane: LaneState, d: int = 0):
        """``steps_per_sync`` transitions of shard ``d``; a lane finishes at
        most once per occupancy, so OR-ing over the block is the exact set
        that finished, and its count is computed here, beside the block's
        work."""
        done_any = torch.zeros(lane.t.shape[0], dtype=torch.bool,
                               device=lane.t.device)
        for _ in range(self.steps_per_sync):
            lane, newly_done = self._lane_step(lane, d)
            done_any |= newly_done
        return lane, done_any, done_any.sum()

    def _blocks(self, lanes: List[LaneState]):
        """A block on every shard: the new shards, each shard's finished
        mask and count, and the pool's count (summed on shard 0's
        device)."""
        out = [self._block(lane, d) for d, lane in enumerate(lanes)]
        total = out[0][2]
        for _, _, c in out[1:]:
            total = total + c.to(total.device)
        return ([o[0] for o in out], [(o[1], o[2]) for o in out], total)

    @torch.no_grad()
    def _refill(self, lane: LaneState, mask, seed, env_id, request_id,
                logit_temp, reward_beta, d: int = 0) -> LaneState:
        """Reset the lanes of shard ``d`` under ``mask`` to fresh request
        state: a new reset state and cache row, nothing of the previous
        occupant survives."""
        L = lane.t.shape[0]
        _, state0 = self.env.reset(L, self._params(lane.reward_beta, d))
        env_state = select_state(mask, state0, lane.env_state)
        cache = lane.cache
        if self.cached:
            cache0 = self._shard_ctx[d][1].cache_init(L)
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

    def _refill_from_host(self, mask: np.ndarray, ints: np.ndarray,
                          floats: np.ndarray) -> None:
        """Refill the lanes under ``mask`` from host rows: ``ints`` (3, L)
        seed, env_id, request_id; ``floats`` (2, L) logit_temp,
        reward_beta (one copy each to each shard's device, of its
        columns)."""
        lanes = []
        for d, lane in enumerate(self.lanes):
            cols = self._lane_slice(d)
            dev = self._shard_ctx[d][0]
            ints_d = torch.as_tensor(ints[:, cols]).to(dev)
            floats_d = torch.as_tensor(floats[:, cols]).to(dev)
            lanes.append(self._refill(
                lane, torch.as_tensor(mask[cols]).to(dev), ints_d[0],
                ints_d[1], ints_d[2], floats_d[0], floats_d[1], d))
        self.lanes = lanes

    def _lane_slice(self, d: int) -> slice:
        return shard_rows(d, self._shards, self.num_lanes)

    def _idle_rows(self):
        """Host rows of an idle refill: request id -1, temperatures 1."""
        L = self.num_lanes
        ints = np.zeros((3, L), np.int64)
        ints[2] = -1
        return ints, np.ones((2, L), np.float32)

    def _lanes_of(self, rid: int) -> np.ndarray:
        """(L,) bool: the occupied lanes running request ``rid``."""
        ids = np.concatenate([lane.request_id.cpu().numpy()
                              for lane in self.lanes])
        return (ids == rid) & self._occupied

    # -- pool sizing -------------------------------------------------------------
    def resize(self, num_lanes: int) -> bool:
        """Rebuild the lane pool at a new size between requests; returns
        whether the size changed.  The pending queue, dedup cache and
        results survive (the parity contract does not depend on the lane
        count), but the pool must be idle: raises :class:`EngineFailure`
        if any lane is occupied."""
        L = self._round_lanes(num_lanes)
        if L == self.num_lanes:
            return False
        self._drain_pending()
        if self._occupied.any():
            raise EngineFailure(
                "cannot resize a lane pool with occupied lanes")
        self.num_lanes = L
        self.lanes = self._init_lanes(L)
        self._occupied = np.zeros(L, bool)
        self.counters["resizes"] += 1
        return True

    @torch.no_grad()
    def prewarm(self, sizes) -> None:
        """Run one block, the drain's gather and an idle refill at each
        lane-pool size, then restore the current size: the first request
        at a new autosize bucket then pays no first-use cost (on CUDA the
        kernel library is built and loaded, and the allocator holds blocks
        of each size)."""
        orig = self.num_lanes
        for L in sorted({self._round_lanes(s) for s in sizes}):
            self.resize(L)
            lanes, done, _ = self._blocks(self.lanes)
            for d, (lane, (nd, _)) in enumerate(zip(lanes, done)):
                order = torch.argsort((~nd).to(torch.int32), stable=True)
                self.env.observe(lane.env_state,
                                 self._params(lane.reward_beta, d)
                                 ).index_select(0, order)
            self._refill_from_host(np.zeros(L, bool), *self._idle_rows())
            for dev, _, _ in self._shard_ctx:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.resize(orig)

    # -- request intake --------------------------------------------------------
    def submit(self, *, num_samples: int = 1, seed: int = 0,
               logit_temp: float = 1.0, reward_beta: float = 1.0) -> int:
        """Queue a request for ``num_samples`` trajectories; returns its
        engine-local id.  With ``logit_temp == reward_beta == 1`` sample i
        reproduces ``forward_rollout(seed, ...)`` trajectory i.  With dedup
        on, a duplicate joins an in-flight primary or is answered from the
        LRU; its id resolves through :meth:`take_results` all the same."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        rid = self._next_id
        self._next_id += 1
        self.counters["requests"] += 1
        if self.dedup_cache_size:
            ckey = (int(seed), int(num_samples), float(logit_temp),
                    float(reward_beta))
            hit = self._dedup_lru.get(ckey)
            if hit is not None:
                self._dedup_lru.move_to_end(ckey)
                self.counters["dedup_hits"] += 1
                self.counters["completed"] += 1
                self._results[rid] = hit._replace(
                    request_id=rid, latency_s=0.0, dedup=True)
                return rid
            prim = self._dedup_inflight.get(ckey)
            if prim is not None and prim in self._requests:
                self.counters["dedup_joins"] += 1
                self._dedup_waiters.setdefault(prim, []).append(rid)
                return rid
            self.counters["dedup_misses"] += 1
            self._dedup_inflight[ckey] = rid
            self._dedup_key_of[rid] = ckey
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
        self._refill_from_host(mask, ints, floats)

    def _drain_pending(self) -> int:
        """Collect the lanes the last block finished (terminal lanes hold
        their state until drained).  Costs one scalar read when nothing
        finished, else a gather of the finished rows."""
        if self._undrained is None:
            return 0
        per_shard, cnt = self._undrained
        self._undrained = None
        count = int(cnt)
        if count == 0:
            self.counters["drain_skips"] += 1
            return 0
        self.counters["drain_packs"] += 1
        parts = []
        for d, (lane, (newly_done, c)) in enumerate(zip(self.lanes,
                                                        per_shard)):
            n = count if self._shards == 1 else int(c)
            if n == 0:
                continue
            order = torch.argsort((~newly_done).to(torch.int32),
                                  stable=True)[:n]
            obs = self.env.observe(lane.env_state,
                                   self._params(lane.reward_beta, d))
            parts.append([x.index_select(0, order).cpu().numpy() for x in (
                obs, lane.log_r, lane.request_id, lane.env_id, lane.t)]
                + [order.cpu().numpy() + self._lane_slice(d).start])
        obs, log_r, rid, eid, steps, order = (
            np.concatenate(cols) for cols in zip(*parts))
        rows = []
        for i in range(count):
            b, r = int(order[i]), int(rid[i])
            if r < 0 or r not in self._requests:
                # cancelled (and perhaps reset to idle) between the block
                # and this drain: nothing to collect
                self._occupied[b] = False
                continue
            rows.append((i, b, r))
        # a finished lane carries a finite log-reward and a length the env
        # can produce; anything else is corrupted device state, which the
        # front answers by quarantining the engine and replaying
        bad = [(i, b, r) for i, b, r in rows
               if not np.isfinite(log_r[i]) or not 1 <= steps[i] <= self.T]
        if bad:
            raise LanePoisoned(
                f"drained lane(s) {[b for _, b, _ in bad]} carry malformed "
                f"state (log_r={[float(log_r[i]) for i, _, _ in bad]}, "
                f"steps={[int(steps[i]) for i, _, _ in bad]})",
                extra={"lanes": [b for _, b, _ in bad],
                       "request_ids": [r for _, _, r in bad]})
        now = time.perf_counter()
        for i, b, r in rows:
            req = self._requests[r]
            req["collected"][int(eid[i])] = (obs[i], float(log_r[i]),
                                             int(steps[i]))
            self._occupied[b] = False
            if len(req["collected"]) == req["num_samples"]:
                got = [req["collected"][j] for j in range(req["num_samples"])]
                res = EngineResult(
                    request_id=r, samples=np.stack([g[0] for g in got]),
                    log_rewards=np.asarray([g[1] for g in got], np.float32),
                    steps=np.asarray([g[2] for g in got], np.int32),
                    latency_s=now - req["t0"])
                del self._requests[r]
                self._results[r] = res
                self.counters["completed"] += 1
                self._dedup_complete(r, res)
        return count

    def _dedup_complete(self, rid: int, res: EngineResult) -> None:
        """Fan a primary's result out to its waiters and keep it in the LRU
        for later duplicates."""
        ckey = self._dedup_key_of.pop(rid, None)
        if ckey is None:
            return
        if self._dedup_inflight.get(ckey) == rid:
            del self._dedup_inflight[ckey]
        for w in self._dedup_waiters.pop(rid, []):
            self._results[w] = res._replace(request_id=w, dedup=True)
            self.counters["completed"] += 1
        self._dedup_lru[ckey] = res
        self._dedup_lru.move_to_end(ckey)
        while len(self._dedup_lru) > self.dedup_cache_size:
            self._dedup_lru.popitem(last=False)

    def _poison_occupied_lanes(self) -> None:
        """lane_state fault: every occupied lane's log-reward becomes NaN,
        which the drain must catch as :class:`LanePoisoned`."""
        lanes = []
        for d, lane in enumerate(self.lanes):
            occ = torch.as_tensor(self._occupied[self._lane_slice(d)]).to(
                lane.log_r.device)
            lanes.append(dataclasses.replace(
                lane, log_r=torch.where(occ, float("nan"), lane.log_r)))
        self.lanes = lanes

    # -- drive -------------------------------------------------------------------
    def step(self) -> int:
        """Drain the previous block's completions, refill free lanes, and
        launch the next block of ``steps_per_sync`` transitions; returns how
        many lanes the drain freed.

        A failing block (an injected ``engine_step`` fault or a real
        exception) is retried with exponential backoff up to
        ``max_step_retries`` times: the block is a function of the lane
        state, which a failure leaves as it was, so a retry replays it
        bitwise.  Exhausted retries raise :class:`EngineFailure`; a
        malformed drained lane raises :class:`LanePoisoned`.  Either way
        the caller should treat the engine as quarantined."""
        finished = self._drain_pending()
        self._fill()
        if not self._occupied.any():
            return finished
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    for f in self._faults.fires("latency"):
                        time.sleep(f.latency_s)
                    if self._faults.fires("lane_state"):
                        self._poison_occupied_lanes()
                    self._faults.maybe_raise("engine_step")
                lanes, newly_done, cnt = self._blocks(self.lanes)
                break
            except Exception as e:
                attempt += 1
                self.counters["step_retries"] += 1
                if attempt > self.max_step_retries:
                    self.counters["step_failures"] += 1
                    raise EngineFailure(
                        f"engine step failed after {attempt} attempts "
                        f"({type(e).__name__}: {e})") from e
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
        self.lanes = lanes
        self._undrained = (newly_done, cnt)
        self.blocks_run += 1
        self.counters["blocks"] += 1
        self.steps_run += self.steps_per_sync
        return finished

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._occupied.any())

    @property
    def has_results(self) -> bool:
        """Completed results awaiting :meth:`take_results`; may hold some
        with no work at all (dedup LRU hits)."""
        return bool(self._results)

    @property
    def occupancy(self) -> float:
        """Fraction of lanes running a sample."""
        return float(self._occupied.mean()) if self.num_lanes else 0.0

    def take_results(self) -> Dict[int, EngineResult]:
        out, self._results = self._results, {}
        return out

    def progress(self, rid: int) -> Dict[str, Any]:
        """Partial progress of a request."""
        req = self._requests.get(rid)
        if req is None:
            done = rid in self._results
            n = self._results[rid].samples.shape[0] if done else 0
            return {"collected": n, "num_samples": n, "complete": done}
        return {"collected": len(req["collected"]),
                "num_samples": req["num_samples"],
                "lanes_in_flight": int(self._lanes_of(rid).sum()),
                "complete": False}

    def cancel(self, rid: int) -> Dict[str, int]:
        """Abort a request: drop its queued samples, reset (and free) its
        lanes, forget its partial results; returns the progress it had made
        (a 504's metadata).  An unknown or completed request returns zeros.
        A dedup waiter is only detached; a primary with waiters hands its
        computation to the first of them (its lanes keep running, their
        request id rewritten on the device)."""
        for prim, ws in list(self._dedup_waiters.items()):
            if rid in ws:
                ws.remove(rid)
                if not ws:
                    del self._dedup_waiters[prim]
                self.counters["cancelled"] += 1
                req = self._requests.get(prim)
                return {"collected": 0,
                        "num_samples": req["num_samples"] if req else 0,
                        "lanes_freed": 0, "pending_removed": 0}
        ws = self._dedup_waiters.pop(rid, None)
        if ws:
            new = ws.pop(0)
            if ws:
                self._dedup_waiters[new] = ws
            ckey = self._dedup_key_of.pop(rid, None)
            if ckey is not None:
                self._dedup_key_of[new] = ckey
                self._dedup_inflight[ckey] = new
            req = self._requests.pop(rid)
            self._requests[new] = req
            if any(s.request_id == rid for s in self._pending):
                self._pending = deque(
                    s._replace(request_id=new) if s.request_id == rid
                    else s for s in self._pending)
            if self._lanes_of(rid).any():
                self.lanes = [dataclasses.replace(
                    lane, request_id=torch.where(
                        lane.request_id == rid,
                        torch.full_like(lane.request_id, new),
                        lane.request_id)) for lane in self.lanes]
            self.counters["cancelled"] += 1
            return {"collected": len(req["collected"]),
                    "num_samples": req["num_samples"],
                    "lanes_freed": 0, "pending_removed": 0}
        before = len(self._pending)
        self._pending = deque(s for s in self._pending
                              if s.request_id != rid)
        removed = before - len(self._pending)
        mask = self._lanes_of(rid)
        lanes_freed = int(mask.sum())
        if lanes_freed:
            # an idle refill: fresh env state and cache rows
            self._refill_from_host(mask, *self._idle_rows())
            self._occupied[mask] = False
        req = self._requests.pop(rid, None)
        if req is not None:
            self.counters["cancelled"] += 1
            ckey = self._dedup_key_of.pop(rid, None)
            if ckey is not None and self._dedup_inflight.get(ckey) == rid:
                del self._dedup_inflight[ckey]
        return {"collected": len(req["collected"]) if req else 0,
                "num_samples": req["num_samples"] if req else 0,
                "lanes_freed": lanes_freed, "pending_removed": removed}

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
