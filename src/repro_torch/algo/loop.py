"""What every training loop shares, and the on-policy loop (port of
``repro.algo.loop.TrainLoop``, single-device plan).

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
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.rollout import RolloutBatch
from ..core.trainer import GFNConfig, make_loss_parts_fn, make_optimizer
from ..core.types import TrainState, train_seed
from ..kernels import ops
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


def loss_and_grads(params: torch.nn.Module, num: torch.Tensor,
                   den: torch.Tensor) -> torch.Tensor:
    """Set every parameter's ``.grad`` to the gradient of the loss given
    as additive parts ``(num, den)`` and return the loss,
    ``num / max(den, 1)``: ``num`` differentiated, the gradients divided,
    as JAX's loop does.  A parameter the loss does not reach gets a zero
    gradient, so Adam moves it on its momentum, as the JAX optimizer
    does.  The gradients are made anew at each call; under capture that
    makes them the graph's static buffers, which every replay rewrites."""
    params = list(params.parameters())
    for p in params:
        p.grad = None
    num.backward()
    den = torch.clamp(den, min=1.0)
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.div_(den)
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
            buf.index_copy_(0, row, metrics[k].view(1))
        log.log_rewards.index_copy_(0, row, batch.log_reward[None])

    def step(self, state: TrainState
             ) -> Tuple[TrainState, Dict[str, torch.Tensor], RolloutBatch]:
        """One eager iteration (the reference on the card).  Returns
        ``(state, metrics, batch)``; metrics read without a host sync."""
        metrics, batch = self.iteration(state)
        return state, metrics, batch

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
            log = ScanLog({k: torch.zeros(num_iterations, **f32)
                           for k in self.METRICS},
                          torch.zeros(num_iterations, self.num_envs, **f32))
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
                checkpoint.save(it + 1, self.checkpoint_tree(
                    state, suite, num_iterations), blocking=False)
        if state.counter.is_cuda:
            ops.check_device_errors(dev)
        if checkpoint is not None and num_iterations > start:
            checkpoint.save(num_iterations, self.checkpoint_tree(
                state, suite, num_iterations))
            checkpoint.wait()
        if mode == "scan":
            return state, (log.metrics, log.log_rewards)
        return state, history


class TrainLoop(CapturableLoop):
    """Environment x policy x objective x sampler, on the policy's device.

    ``policy`` is a :class:`repro_torch.core.policies.TransformerPolicy` or
    :class:`repro_torch.core.policies.MLPPolicy` whose parameters require
    grad; ``sampler`` is a sampler of :mod:`repro_torch.algo.samplers` or
    its registry name (``"on_policy"``, the default, ``"eps_noisy"``,
    ``"replay"``, ``"backward_replay"``).  Iteration ``i`` of a run seeded
    ``seed`` draws its noise from ``train_seed(seed, i)``.  The sampler's
    state (a replay buffer) rides in ``TrainState.sampler``, made by
    :meth:`init` before any capture, as JAX's ``LoopState.sampler``: a
    captured iteration adds to it and draws from it on the device."""

    #: the metrics of an iteration, in the order of JAX's metrics dict
    METRICS = ("loss", "log_z", "mean_log_reward")

    def __init__(self, env, env_params, policy, cfg: GFNConfig,
                 sampler=None):
        if not all(p.requires_grad for p in policy.params.parameters()):
            raise ValueError("TrainLoop needs a policy whose parameters "
                             "require grad (requires_grad=True)")
        self.env, self.env_params = env, env_params
        self.policy, self.cfg = policy, cfg
        self.sampler = make_sampler(sampler or "on_policy")
        self._init_sampler, self._sample = self.sampler.build(
            env, env_params, policy, cfg)
        self.parts_fn = make_loss_parts_fn(env, policy, cfg)

    @property
    def num_envs(self) -> int:
        return self.sampler.batch_size(self.cfg)

    def init(self, seed: int) -> TrainState:
        train_seed(seed, 0)                   # the seed's range check
        params = self.policy.params
        dev = next(params.parameters()).device
        return TrainState(params=params,
                          optimizer=make_optimizer(self.cfg, params),
                          seed=int(seed),
                          counter=torch.zeros((), dtype=torch.int64,
                                              device=dev),
                          sampler=self._init_sampler())

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
        0-dim tensors on the device (``loss``, ``log_z`` after the update,
        ``mean_log_reward``)."""
        batch = self.sample(state)
        loss = self.loss_and_grads(batch)
        state.optimizer.step()
        metrics = {"loss": loss,
                   "log_z": self.policy.params["log_z"].detach().clone(),
                   "mean_log_reward": batch.log_reward.mean()}
        self.log_row(state, log, metrics, batch)
        state.counter.add_(1)
        return metrics, batch

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
        tree = {n: t.to(torch.int32) if t.dtype == torch.int64 else t
                for n, t in self._state_leaves(state).items()}
        p0 = next(iter(state.params.flat().values()))
        count = self._adam_state(state.optimizer, p0)["step"]
        tree[f"{self._adam_prefix()}/.count"] = count.to(torch.int32)
        if suite is not None:
            tree.update(suite.metrics_state(num_iterations))
        return tree

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
        count = torch.zeros((), dtype=torch.float32)
        target[f"{self._adam_prefix()}/.count"] = count
        checkpoint.restore(at, target)
        with torch.no_grad():
            for p in state.params.flat().values():
                self._adam_state(state.optimizer, p)["step"].copy_(count)
        if suite is not None:
            suite.load_metrics_state(checkpoint.load(at, ".metrics"),
                                     num_iterations)
        drop = getattr(self.policy, "weights_replaced", None)
        if drop is not None:
            drop()
        return at
