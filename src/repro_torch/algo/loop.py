"""What every training loop shares, and the on-policy loop (port of
``repro.algo.loop.TrainLoop``).

A loop is an object with the :class:`CapturableLoop` contract: ``init(seed)``
makes a fresh carry (a :class:`repro_torch.core.types.TrainState`, whose
iteration counter, and the noise seed read from it, lives on the device)
and ``iteration(state, log)`` runs one iteration on the carry's tensors,
in place, with no host read.  :class:`TrainLoop` is the on-policy loop;
EB-GFN's joint loop (:class:`repro_torch.core.ebgfn.EBGFNLoop`) is the
other.  One on-policy iteration is the JAX step's ``core``
(``repro/algo/loop.py:128-151``): sample a batch, compute the objective's
additive ``(num, den)`` parts, differentiate ``num``, divide the
gradients by ``max(den, 1)``, take the Adam step.

How a loop is driven, as JAX's ``mode`` (:meth:`CapturableLoop.run`):

- ``mode="python"``: one iteration at a time, with the eval suite and a
  callback between iterations (JAX jits the step and calls host code
  between calls).
- ``mode="scan"``: the whole run, with the metrics of every iteration
  written into device buffers and read once, at the end (JAX's
  ``lax.scan`` over the step).

On CUDA both modes run the run's first iteration eagerly, capture the
next in a CUDA graph (:class:`CapturedIteration`, the counterpart of
JAX's jitted step) and replay it for every iteration after: the
iteration's thousands of kernel launches go out without the Python host.
On the CPU both run the loop's ``iteration`` in a loop; it is the same
Python function the graph captures.

Where the iteration runs is the loop's execution plan
(:mod:`repro_torch.algo.plan`, JAX's ``plan``): ``single``;
``vmap_seeds(S)``, S runs whose stacked parameters the iteration takes
under ``torch.func.vmap`` over ``functional_call`` (each kernel call site
launches once for all S: the wrappers' batching rules fold the seed axis
into the batch axis); ``data_parallel(D)``, one rank a shard, the
``(num, den)`` sums and gradients all-reduced before the division and the
Adam step (on CUDA inside the captured iteration, over NCCL); and
``seeds_x_data(S, D)``, the vmap inside each rank.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import torch
import torch.distributed as dist

from ..core.rollout import RolloutBatch
from ..core.trainer import GFNConfig, make_loss_parts_fn, make_optimizer
from ..core.types import TrainState, train_seed
from ..kernels import ops
from ..nn.core import ParamTree
from .plan import ExecutionPlan, VmapSeedsPlan, make_plan, seed_of
from .samplers import make_sampler

class ScanLog(NamedTuple):
    """``mode="scan"``'s per-iteration outputs on the device: ``metrics``
    name -> (num_iterations,) and ``log_rewards`` (num_iterations, B); the
    iteration at counter i writes row i."""
    metrics: Dict[str, torch.Tensor]
    log_rewards: torch.Tensor


class CapturedIteration:
    """One training iteration of a loop (:class:`CapturableLoop`) captured
    in a CUDA graph (the port's counterpart of JAX's jitted step).

    Building it runs the iteration the state is at eagerly, on a side
    stream (the warm-up that capture needs: cuBLAS workspaces, the
    optimizer's state, every lazily made buffer), under
    ``torch.cuda.set_sync_debug_mode("error")`` so that any host sync in
    the body raises there, with its op named.  Its outputs are
    :attr:`warmup`.  Then it captures the next iteration on the same
    stream; the capture runs nothing.  Each call replays the graph: one
    iteration, on the static input and output buffers the capture made
    (the state's counter, parameters, gradients and optimizer states are
    updated in place), and returns the static ``(metrics, batch)``, which
    the next replay overwrites.  A failure to capture or replay raises;
    nothing falls back to the eager loop.

    :attr:`launches` holds each kernel wrapper's launches in one replay,
    :attr:`replays` the replays so far, :attr:`warmup_seconds` and
    :attr:`capture_seconds` the one-off costs."""

    def __init__(self, loop: "CapturableLoop", state: TrainState,
                 log: Optional[ScanLog] = None):
        dev = state.counter.device
        ops.device_error_counts(dev)          # outlives the graph
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.warmup = loop.iteration(state, log)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(stream)
        ops.check_device_errors(dev)
        self.warmup_seconds = time.perf_counter() - t0
        self.graph = torch.cuda.CUDAGraph()
        before = ops.captured_launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream):
            self.outputs = loop.iteration(state, log)
        self.capture_seconds = time.perf_counter() - t0
        after = ops.captured_launches()
        self.launches = {k: after[k] - before[k] for k in after}
        self.replays = 0
        self._weights_replaced = getattr(loop.policy, "weights_replaced",
                                         None)

    def __call__(self) -> Tuple[Dict[str, torch.Tensor], RolloutBatch]:
        self.graph.replay()
        self.replays += 1
        if self._weights_replaced is not None:
            self._weights_replaced()
        return self.outputs


def _grads_of(params: torch.nn.Module, num: torch.Tensor
              ) -> List[torch.Tensor]:
    """Differentiate ``num`` into fresh ``.grad``s of ``params`` and
    return them in parameter order.  A parameter ``num`` does not reach
    gets a zero gradient, so Adam moves it on its momentum, as the JAX
    optimizer does.  Made anew at each call; under capture that makes
    them the graph's static buffers, which every replay rewrites."""
    params = list(params.parameters())
    for p in params:
        p.grad = None
    num.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def loss_and_grads(params: torch.nn.Module, num: torch.Tensor,
                   den: torch.Tensor) -> torch.Tensor:
    """Set every parameter's ``.grad`` to the gradient of the loss given
    as additive parts ``(num, den)`` and return the loss,
    ``num / max(den, 1)``: ``num`` differentiated (:func:`_grads_of`),
    the gradients divided, as JAX's loop does."""
    grads = _grads_of(params, num)
    den = torch.clamp(den, min=1.0)
    with torch.no_grad():
        for g in grads:
            g.div_(den)
    return num.detach() / den


class CapturableLoop:
    """What a training loop gives to be stepped, captured and run: a
    subclass defines ``init(seed)`` (a fresh carry), ``iteration(state,
    log)`` (the body, with no host read; it writes its metrics with
    :meth:`log_row` and advances the counter), :attr:`METRICS` (the names
    of its metrics, in order, the first the loss), :attr:`num_envs` (the
    batch's rows) and ``policy``.  After :meth:`run` on CUDA,
    :attr:`captured` is the run's :class:`CapturedIteration` (None before,
    and on the CPU)."""

    METRICS: Tuple[str, ...] = ()
    captured: Optional[CapturedIteration] = None
    #: the shape every metric of an iteration has: () or a seed plan's (S,)
    metric_shape: Tuple[int, ...] = ()

    @property
    def num_envs(self) -> int:
        raise NotImplementedError

    def trained(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Every tensor the iteration trains, by name: the policy's
        parameters (``/``-keyed leaves)."""
        return self.policy.params.flat()

    @staticmethod
    def log_row(state: TrainState, log: Optional[ScanLog],
                metrics: Dict[str, torch.Tensor],
                batch: RolloutBatch) -> None:
        """Write an iteration's metrics and its batch's log-rewards into
        ``log``'s row ``counter`` (nothing without a log)."""
        if log is None:
            return
        row = state.counter.view(1)
        for k, buf in log.metrics.items():
            buf.index_copy_(0, row, metrics[k][None])
        log.log_rewards.index_copy_(0, row, batch.log_reward[None])

    def step(self, state: TrainState
             ) -> Tuple[TrainState, Dict[str, torch.Tensor], RolloutBatch]:
        """One eager iteration (the reference on the card).  Returns
        ``(state, metrics, batch)``; metrics read without a host sync."""
        metrics, batch = self.iteration(state)
        return state, metrics, batch

    def save_checkpoint(self, checkpoint, step: int, state: TrainState,
                        suite=None, num_iterations: Optional[int] = None,
                        blocking: bool = True) -> None:
        """Write :meth:`checkpoint_tree` as step ``step``."""
        checkpoint.save(step, self.checkpoint_tree(state, suite,
                                                   num_iterations),
                        blocking=blocking)

    def capture(self, state: TrainState,
                log: Optional[ScanLog] = None) -> CapturedIteration:
        """Run the iteration ``state`` is at eagerly and capture the next
        in a CUDA graph (:class:`CapturedIteration`); CUDA only."""
        if not state.counter.is_cuda:
            raise ValueError(f"{type(self).__name__}.capture needs a CUDA "
                             "device; the CPU runs step()")
        return CapturedIteration(self, state, log)

    def run(self, seed: int, num_iterations: int, *, mode: str = "python",
            callback: Optional[Callable] = None, suite=None,
            checkpoint=None, checkpoint_every: int = 0,
            restore: bool = False):
        """Run ``num_iterations`` iterations from a fresh state.

        - ``mode="python"``: returns ``(state, history)``; history
          collects ``callback(it, state, metrics, batch)`` after every
          iteration.  On CUDA, ``metrics`` and ``batch`` are the graph's
          static outputs from iteration 1 on: the next replay overwrites
          them, so a callback copies what it keeps.
        - ``mode="scan"``: returns ``(state, (metrics, log_rewards))``,
          stacked over time as JAX's (``metrics`` name -> (n,),
          ``log_rewards`` (n, B)), on the device; a callback raises, as in
          JAX.

        An :class:`repro_torch.evals.EvalSuite` records its rows after the
        iterations ``it`` with ``it % suite.every == 0`` (``suite.rows()``)
        in both modes, between replays; it reads the parameters and draws
        noise of its own, so training runs the same with and without it.
        On CUDA the first iteration runs eagerly and the rest replay one
        captured iteration (:attr:`captured`); a SubTB length out of range
        inside the graph raises after the run.

        ``checkpoint`` (a :class:`repro_torch.checkpoint.CheckpointManager`,
        python mode only, a loop with :meth:`checkpoint_tree`) saves the
        state every ``checkpoint_every`` iterations (asynchronously) and
        once at the end; ``restore=True`` resumes from its latest complete
        step, written into the state's tensors in place before the first
        iteration (and so before any capture)."""
        if mode not in ("python", "scan"):
            raise ValueError(f"unknown mode {mode!r}; expected 'python' | "
                             "'scan'")
        if callback is not None and mode != "python":
            raise ValueError(
                f"callback is only supported in mode='python' (got "
                f"mode={mode!r}); compiled modes cannot call host code")
        if checkpoint is not None and (mode != "python" or not hasattr(
                self, "checkpoint_tree")):
            raise ValueError(
                f"checkpointing needs mode='python' "
                f"and a loop that names its state; {type(self).__name__} "
                f"in mode={mode!r} has no checkpoints")
        if (restore or checkpoint_every > 0) and checkpoint is None:
            raise ValueError(
                "restore/checkpoint_every need a checkpoint manager; pass "
                "checkpoint=CheckpointManager(dir) (silently retraining "
                "from scratch would be worse than this error)")
        state = self.init(seed)
        start = 0
        if checkpoint is not None and restore:
            start = self.restore_state(state, checkpoint, suite=suite,
                                       num_iterations=num_iterations) or 0
        dev = state.counter.device
        log = None
        if mode == "scan":
            f32 = dict(dtype=torch.float32, device=dev)
            n = (num_iterations,) + tuple(self.metric_shape)
            log = ScanLog({k: torch.zeros(n, **f32) for k in self.METRICS},
                          torch.zeros(n + (self.num_envs,), **f32))
        self.captured = None
        history = []
        for it in range(start, num_iterations):
            if not state.counter.is_cuda:
                metrics, batch = self.iteration(state, log)
            elif self.captured is None:
                self.captured = self.capture(state, log)
                metrics, batch = self.captured.warmup
            else:
                metrics, batch = self.captured()
            if suite is not None:
                suite.maybe_record(it)
            if callback is not None:
                history.append(callback(it, state, metrics, batch))
            if checkpoint is not None and checkpoint_every > 0 \
                    and (it + 1) % checkpoint_every == 0 \
                    and it + 1 < num_iterations:
                # save() copies to the host before it returns, so the next
                # replay may overwrite the state at once
                self.save_checkpoint(checkpoint, it + 1, state, suite,
                                     num_iterations, blocking=False)
        if state.counter.is_cuda:
            ops.check_device_errors(dev)
        if checkpoint is not None and num_iterations > start:
            self.save_checkpoint(checkpoint, num_iterations, state, suite,
                                 num_iterations)
            checkpoint.wait()
        if mode == "scan":
            return state, (log.metrics, log.log_rewards)
        return state, history


def _batch_fields(batch: RolloutBatch) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(batch, f.name)
            for f in dataclasses.fields(RolloutBatch)}


def _sampler_leaves(state) -> Dict[str, torch.Tensor]:
    """A sampler state's tensors by name (a replay buffer's data, insert
    position and size; nothing for a stateless sampler)."""
    if state is None:
        return {}
    return {**{f"data/{k}": t for k, t in state.data.items()},
            "insert_pos": state.insert_pos, "size": state.size}


def _sampler_of(leaves: Mapping[str, torch.Tensor], like):
    """The sampler state ``like`` over ``leaves`` (inverse of
    :func:`_sampler_leaves`)."""
    if like is None:
        return None
    return dataclasses.replace(
        like, data={k[5:]: t for k, t in leaves.items()
                    if k.startswith("data/")},
        insert_pos=leaves["insert_pos"], size=leaves["size"])


def _stacked_tree(flats) -> ParamTree:
    """A trainable :class:`ParamTree` whose every leaf stacks the leaves of
    the ``/``-keyed parameter mappings ``flats`` along a new leading axis
    (a seed plan's parameters)."""
    tree: Dict = {}
    for name in flats[0]:
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = torch.stack([f[name].detach() for f in flats])
    return ParamTree(tree, requires_grad=True)


class TrainLoop(CapturableLoop):
    """Environment x policy x objective x sampler x plan.

    ``policy`` is a :class:`repro_torch.core.policies.TransformerPolicy` or
    :class:`repro_torch.core.policies.MLPPolicy` whose parameters require
    grad; ``sampler`` is a sampler of :mod:`repro_torch.algo.samplers` or
    its registry name (``"on_policy"``, the default, ``"eps_noisy"``,
    ``"replay"``, ``"backward_replay"``).  Iteration ``i`` of a run seeded
    ``seed`` draws its noise from ``train_seed(seed, i)``.  The sampler's
    state (a replay buffer) rides in ``TrainState.sampler``, made by
    :meth:`init` before any capture, as JAX's ``LoopState.sampler``: a
    captured iteration adds to it and draws from it on the device.

    ``plan`` is an :class:`repro_torch.algo.plan.ExecutionPlan` or a name
    (``"single"``, the default, ``"vmap_seeds"``, ``"data_parallel"``,
    ``"seeds_x_data"``, ``"auto"``).  Under a seed plan, seed s of a run
    seeded ``seed`` is the single run seeded ``seed_of(seed, s)``: its
    noise is that run's, and its initial parameters are
    ``seed_params(seed_of(seed, s))`` (a ``/``-keyed mapping; the policy's
    own parameters for every seed when ``seed_params`` is None).
    ``state.params`` then stacks the S runs' leaves, and every metric is
    (S,).  Under a data-parallel plan this process is one rank: it draws
    its shard's rows (:class:`repro_torch.algo.plan.ShardInfo`) and the
    group sums the loss parts and gradients; a sampler whose ``build``
    takes no ``shard`` is refused on more than one shard, as in JAX."""

    #: the metrics of an iteration, in the order of JAX's metrics dict
    METRICS = ("loss", "log_z", "mean_log_reward")

    def __init__(self, env, env_params, policy, cfg: GFNConfig,
                 sampler=None, plan=None,
                 seed_params: Optional[Callable[[int], Mapping]] = None):
        if not all(p.requires_grad for p in policy.params.parameters()):
            raise ValueError("TrainLoop needs a policy whose parameters "
                             "require grad (requires_grad=True)")
        self.env, self.env_params = env, env_params
        self.policy, self.cfg = policy, cfg
        self.sampler = make_sampler(sampler or "on_policy")
        self.plan = make_plan(plan, num_envs=cfg.num_envs)
        self.shard = self.plan.shard_info()
        self.seed_params = seed_params
        sig = inspect.signature(self.sampler.build).parameters
        shard_aware = "shard" in sig or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.values())
        if shard_aware:
            self._init_sampler, self._sample = self.sampler.build(
                env, env_params, policy, cfg, shard=self.shard)
        else:
            if self.shard.num_shards > 1:
                raise TypeError(
                    f"sampler {type(self.sampler).__name__} does not accept "
                    "the 'shard' argument and cannot run under a sharded "
                    "plan; add shard=None to its build() signature (see "
                    "repro_torch.algo.samplers)")
            self._init_sampler, self._sample = self.sampler.build(
                env, env_params, policy, cfg)
        self.parts_fn = make_loss_parts_fn(env, policy, cfg)
        self.metric_shape = (self.plan.seeds,) if self.plan.seeds else ()
        self._seed_hi: Optional[torch.Tensor] = None
        self.plan.join(next(policy.params.parameters()).device)

    @property
    def num_envs(self) -> int:
        """The rows of this process's batch (its shard's, on a sharded
        plan)."""
        return self.shard.split_batch(self.sampler.batch_size(self.cfg))

    @property
    def rank(self) -> int:
        return self.shard.rank

    def init(self, seed: int) -> TrainState:
        params = self.policy.params
        dev = next(params.parameters()).device
        S = self.plan.seeds
        if not S:
            train_seed(seed, 0)               # the seed's range check
            return TrainState(params=params,
                              optimizer=make_optimizer(self.cfg, params),
                              seed=int(seed),
                              counter=torch.zeros((), dtype=torch.int64,
                                                  device=dev),
                              sampler=self._init_sampler())
        seeds = [seed_of(seed, s) for s in range(S)]
        for sd in seeds:
            train_seed(sd, 0)
        flats = [params.flat() if self.seed_params is None
                 else self.seed_params(sd) for sd in seeds]
        stacked = _stacked_tree([{n: f[n].to(dev) for n in params.flat()}
                                 for f in flats])
        self._seed_hi = torch.tensor([sd << 32 for sd in seeds],
                                     dtype=torch.int64, device=dev)
        one = self._init_sampler()
        sampler = _sampler_of({k: t.expand((S,) + t.shape).clone()
                               for k, t in _sampler_leaves(one).items()},
                              one)
        return TrainState(params=stacked,
                          optimizer=make_optimizer(self.cfg, stacked,
                                                   seeds=S),
                          seed=int(seed),
                          counter=torch.zeros((), dtype=torch.int64,
                                              device=dev),
                          sampler=sampler)

    def trained(self, state: TrainState) -> Dict[str, torch.Tensor]:
        return state.params.flat()

    def noise_seeds(self, state: TrainState) -> torch.Tensor:
        """The iteration's noise seed, on the device: 0-dim, or (S,) under a
        seed plan (``train_seed(seed_of(seed, s), counter)``)."""
        if self.plan.seeds:
            return state.counter + self._seed_hi
        return state.noise_seed()

    def sample(self, state: TrainState) -> RolloutBatch:
        """The batch of the iteration ``state`` is at; the sampler's state
        (``state.sampler``) is updated in place."""
        state.sampler, batch = self._sample(state.sampler, state.noise_seed(),
                                            state.counter)
        return batch

    def loss_and_grads(self, batch: RolloutBatch) -> torch.Tensor:
        """:func:`loss_and_grads` of the loop's objective on ``batch``."""
        return loss_and_grads(self.policy.params, *self.parts_fn(batch))

    def iteration(self, state: TrainState, log: Optional[ScanLog] = None
                  ) -> Tuple[Dict[str, torch.Tensor], RolloutBatch]:
        """One iteration on the state's tensors, with no host read: the
        body that :meth:`step` runs and that :class:`CapturedIteration`
        captures.  Writes its metrics into ``log``'s row ``counter``, then
        advances the counter.  Returns ``(metrics, batch)``; metrics are
        device tensors (``loss``, ``log_z`` after the update,
        ``mean_log_reward``), 0-dim or (S,) under a seed plan."""
        if self.plan.seeds:
            grads, num, den, mlr, batch = self._seed_parts(state)
        else:
            batch = self.sample(state)
            num, den = self.parts_fn(batch)
            grads = _grads_of(self.policy.params, num)
            num, mlr = num.detach(), batch.log_reward.mean()
        loss, mlr = self._reduce_and_step(state, grads, num, den, mlr)
        metrics = {"loss": loss,
                   "log_z": state.params["log_z"].detach().clone(),
                   "mean_log_reward": mlr}
        self.log_row(state, log, metrics, batch)
        state.counter.add_(1)
        return metrics, batch

    def run(self, seed: int, num_iterations: int, *, mode: str = "python",
            num_seeds: Optional[int] = None, **kwargs):
        """:meth:`CapturableLoop.run`, and JAX's ``mode="vmap_seeds"``: the
        legacy alias of a ``vmap_seeds(num_seeds)`` plan's scan run, on the
        single plan only, returning ``(state, metrics)`` with the seed axis
        leading every metric.  Under a sharded plan the eval suite records
        on rank 0 only, from its replicated parameters."""
        if mode == "vmap_seeds":
            return self._run_legacy_vmap_seeds(seed, num_iterations,
                                               num_seeds, kwargs)
        if self.rank != 0:
            kwargs["suite"] = None
        return super().run(seed, num_iterations, mode=mode, **kwargs)

    def _run_legacy_vmap_seeds(self, seed, num_iterations, num_seeds,
                               kwargs):
        if kwargs.get("checkpoint") is not None:
            raise ValueError(
                "checkpointing needs the python driver (mode='python'); "
                "compiled modes cannot call host code mid-run")
        if kwargs.get("callback") is not None:
            raise ValueError(
                "callback is only supported in mode='python' (got "
                "mode='vmap_seeds'); compiled modes cannot call host code")
        if type(self.plan) is not ExecutionPlan:
            raise ValueError(
                f"mode='vmap_seeds' composes only with the single-device "
                f"plan (got plan={self.plan.name!r}); use "
                f"plan=make_plan('seeds_x_data', num_seeds=...) or "
                f"make_plan('vmap_seeds', num_seeds=...) instead")
        if num_seeds is None:
            raise ValueError("mode='vmap_seeds' requires num_seeds")
        loop = TrainLoop(self.env, self.env_params, self.policy, self.cfg,
                         sampler=self.sampler,
                         plan=VmapSeedsPlan(num_seeds),
                         seed_params=self.seed_params)
        state, (metrics, _) = loop.run(seed, num_iterations, mode="scan")
        return state, {k: v.transpose(0, 1) for k, v in metrics.items()}

    def _seed_parts(self, state: TrainState):
        """Sample and differentiate every seed's batch at once: the
        iteration of one seed under ``torch.func.vmap`` over the stacked
        parameters (``functional_call`` of the policy's tree), its
        gradient by ``torch.func.grad_and_value`` of ``num``.  Returns the
        stacked gradients (in parameter order), ``num``, ``den`` and the
        batch's mean log-reward, each (S,), and the (S, ...) batch."""
        tree = self.policy.params
        names = [n for n, _ in tree.named_parameters()]
        counter = state.counter
        like = state.sampler

        def one(params, noise_seed, leaves):
            p = dict(zip(names, params))
            sampler_state = _sampler_of(leaves, like)
            batch = torch.func.functional_call(tree, p, (
                lambda: self._sample(sampler_state, noise_seed,
                                     counter)[1],))

            def num_of(q):
                return torch.func.functional_call(tree, q, (self.parts_fn,
                                                            batch))

            grads, (num, den) = torch.func.grad_and_value(
                num_of, has_aux=True)(p)
            return ([grads[n] for n in names], num, den,
                    batch.log_reward.mean(), _batch_fields(batch))

        stacked = [t.detach() for t in state.params.parameters()]
        grads, num, den, mlr, fields = torch.func.vmap(one)(
            stacked, self.noise_seeds(state), _sampler_leaves(like))
        return grads, num, den, mlr, RolloutBatch(**fields)

    def _reduce_and_step(self, state: TrainState, grads, num, den, mlr):
        """Sum ``(grads, num, den, mlr)`` over the plan's group (one
        all-reduce of one flat buffer; nothing off a sharded plan), set
        every parameter's gradient to its sum over ``max(den, 1)`` (per
        seed under a seed plan), take the optimizer step, and return the
        loss and the mean log-reward (the shards' mean)."""
        with torch.no_grad():
            if self.shard.axis is not None:
                parts = [g.reshape(-1) for g in grads] + [
                    t.reshape(-1).to(torch.float32) for t in (num, den, mlr)]
                flat = self.shard.psum(torch.cat(parts))
                out, o = [], 0
                for t in parts:
                    out.append(flat[o:o + t.numel()])
                    o += t.numel()
                grads = [f.view(g.shape) for f, g in zip(out, grads)]
                num, den, mlr = (f.view(t.shape) for f, t
                                 in zip(out[-3:], (num, den, mlr)))
                mlr = mlr / self.shard.num_shards
            den = torch.clamp(den, min=1.0)
            for p, g in zip(state.params.parameters(), grads):
                p.grad = g.div_(den.view(den.shape + (1,) * (g.dim()
                                                             - den.dim())))
        state.optimizer.step()
        return num / den, mlr

    # -- checkpoints in the JAX package's layout -------------------------------
    def _adam_prefix(self) -> str:
        """JAX's chain puts ``clip_by_global_norm`` (stateless) before
        ``scale_by_adam``, so Adam's state is tuple entry 1 with a clip
        and 0 without."""
        return (f".train/.opt_state/"
                f"{0 if self.cfg.max_grad_norm is None else 1}")

    @staticmethod
    def _adam_state(optimizer: torch.optim.Optimizer,
                    p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The Adam state of ``p``, made as torch makes it at the first
        step when there is none yet: ``step`` a float32 0-dim tensor (on
        the device when capturable), the moments zeros like ``p``."""
        st = optimizer.state[p]
        if not st:
            group = next(g for g in optimizer.param_groups
                         if any(q is p for q in g["params"]))
            on_dev = group["capturable"] or group.get("fused")
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device if on_dev else "cpu")
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return st

    def _state_leaves(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The train and sampler leaves both packages' loop states share,
        by JAX's flattened names, as the port's own tensors (Adam's
        ``count`` aside: torch keeps a step per parameter)."""
        out = {}
        params = state.params.flat()
        adam = self._adam_prefix()
        for n, p in params.items():
            out[f".train/.params/{n}"] = p
        for n, p in params.items():
            out[f"{adam}/.mu/{n}"] = self._adam_state(
                state.optimizer, p)["exp_avg"]
        for n, p in params.items():
            out[f"{adam}/.nu/{n}"] = self._adam_state(
                state.optimizer, p)["exp_avg_sq"]
        out[".train/.step"] = state.counter
        buf = state.sampler
        if buf is not None:
            for k, t in buf.data.items():
                out[f".sampler/.data/log_reward" if k == "log_reward"
                    else f".sampler/.data/state/.{k}"] = t
            out[".sampler/.insert_pos"] = buf.insert_pos
            out[".sampler/.size"] = buf.size
        return out

    def checkpoint_tree(self, state: TrainState, suite=None,
                        num_iterations: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
        """The state as a checkpoint tree under JAX's flattened names
        (``repro.checkpoint.manager._flatten`` of a ``LoopState``) and
        dtypes (JAX's integers are int32): the policy params
        (``.train/.params/...``), Adam's ``.count`` / ``.mu`` / ``.nu``,
        ``.train/.step``, a replay buffer under ``.sampler`` and the eval
        rows under ``.metrics`` (sized for ``num_iterations``).  JAX's
        threefry ``.train/.key`` has no counterpart: iteration i draws
        from ``(seed, i)`` here."""
        leaves = self._state_leaves(state)
        p0 = next(iter(state.params.flat().values()))
        leaves[f"{self._adam_prefix()}/.count"] = self._adam_state(
            state.optimizer, p0)["step"].to(torch.int32)
        S = self.plan.seeds
        if S:
            # JAX's seed layout: every leaf carries the seed axis
            for n in (".train/.step", f"{self._adam_prefix()}/.count"):
                leaves[n] = leaves[n].expand(S)
        if self.shard.axis is not None:
            # JAX's sharded layout: the sampler's leaves carry a leading
            # shard axis, gathered here for rank 0 to write
            for n, t in leaves.items():
                if n.startswith(".sampler"):
                    leaves[n] = self._gathered(t)
        tree = {n: t.to(torch.int32) if t.dtype == torch.int64 else t
                for n, t in leaves.items()}
        if suite is not None:
            tree.update(suite.metrics_state(num_iterations))
        return tree

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order (a collective: every
        rank calls it)."""
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shard.num_shards)]
        dist.all_gather(parts, x)
        return torch.stack(parts).to(t.dtype)

    def save_checkpoint(self, checkpoint, step: int, state: TrainState,
                        suite=None, num_iterations: Optional[int] = None,
                        blocking: bool = True) -> None:
        """Every rank builds the tree (the sampler leaves' gather is a
        collective); rank 0 writes it."""
        tree = self.checkpoint_tree(state, suite, num_iterations)
        if self.rank == 0:
            checkpoint.save(step, tree, blocking=blocking)

    def restore_state(self, state: TrainState, checkpoint,
                      step: Optional[int] = None, suite=None,
                      num_iterations: Optional[int] = None) -> Optional[int]:
        """Write step ``step`` of ``checkpoint`` (a
        :class:`repro_torch.checkpoint.CheckpointManager`; its latest
        complete step when None) into ``state`` in place, with ``copy_``,
        so tensors a CUDA graph holds keep their storage: params, Adam's
        moments and step (JAX's int32 ``count`` into every parameter's
        float32 ``step``, the state made first where torch has none yet),
        the counter, the buffer, and the eval rows (JAX's
        ``_migrate_metrics``).  A leaf missing or of another shape raises
        (JAX's ``_check_restored_shapes``).  The fused step's weight copies
        are dropped after.  Returns the step restored (None: the directory
        holds none, and ``state`` is untouched)."""
        at = checkpoint.latest_step() if step is None else step
        if at is None:
            return None
        target = self._state_leaves(state)
        S = self.plan.seeds
        lead = (S,) if S else ()
        count = torch.zeros(lead, dtype=torch.float32)
        target[f"{self._adam_prefix()}/.count"] = count
        counter = state.counter
        if S:
            target[".train/.step"] = torch.zeros(S, dtype=torch.int64)
        # a sharded plan reads every shard's sampler leaves and keeps its own
        local = {}
        if self.shard.axis is not None:
            for n, t in list(target.items()):
                if n.startswith(".sampler"):
                    local[n] = t
                    target[n] = torch.zeros((self.shard.num_shards,)
                                            + t.shape, dtype=t.dtype)
        checkpoint.restore(at, target)
        with torch.no_grad():
            if S:
                counter.copy_(target[".train/.step"][0])
            for n, t in local.items():
                t.copy_(target[n][self.rank])
            for p in state.params.flat().values():
                self._adam_state(state.optimizer, p)["step"].copy_(
                    count[0] if S else count)
        if suite is not None:
            suite.load_metrics_state(checkpoint.load(at, ".metrics"),
                                     num_iterations)
        drop = getattr(self.policy, "weights_replaced", None)
        if drop is not None:
            drop()
        return at
