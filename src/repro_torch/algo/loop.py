"""The on-policy training loop (port of ``repro.algo.loop.TrainLoop``,
python mode, single-device plan).

One iteration is the JAX step's ``core`` (``repro/algo/loop.py:128-151``):
sample a batch, compute the objective's additive ``(num, den)`` parts,
differentiate ``num``, divide the gradients by ``max(den, 1)``, take the
Adam step.  Parameters and optimizer state update in place; the loop's
carry is a :class:`repro_torch.core.types.TrainState`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.rollout import RolloutBatch
from ..core.trainer import GFNConfig, make_loss_parts_fn, make_optimizer
from ..core.types import TrainState, train_seed
from .samplers import OnPolicySampler


class TrainLoop:
    """Environment x policy x objective x sampler, on the policy's device.

    ``policy`` is a :class:`repro_torch.core.policies.TransformerPolicy` or
    :class:`repro_torch.core.policies.MLPPolicy` whose parameters require
    grad; ``sampler`` defaults to
    :class:`OnPolicySampler`.  Iteration ``i`` of a run seeded ``seed``
    draws its rollout noise from ``train_seed(seed, i)``."""

    def __init__(self, env, env_params, policy, cfg: GFNConfig,
                 sampler: Optional[OnPolicySampler] = None):
        if not all(p.requires_grad for p in policy.params.parameters()):
            raise ValueError("TrainLoop needs a policy whose parameters "
                             "require grad (requires_grad=True)")
        self.env, self.env_params = env, env_params
        self.policy, self.cfg = policy, cfg
        self.sampler = sampler or OnPolicySampler()
        self._sample = self.sampler.build(env, env_params, policy, cfg)
        self.parts_fn = make_loss_parts_fn(env, policy, cfg)

    def init(self, seed: int) -> TrainState:
        params = self.policy.params
        return TrainState(params=params,
                          optimizer=make_optimizer(self.cfg, params),
                          step=0, seed=int(seed))

    def sample(self, state: TrainState) -> RolloutBatch:
        """The batch of the iteration ``state`` is at."""
        return self._sample(train_seed(state.seed, state.step), state.step)

    def loss_and_grads(self, batch: RolloutBatch) -> torch.Tensor:
        """Set every parameter's ``.grad`` to the gradient of the loss on
        ``batch`` and return the loss, ``num / max(den, 1)``.  A parameter
        the loss does not reach gets a zero gradient, so Adam moves it on
        its momentum, as the JAX optimizer does."""
        params = list(self.policy.params.parameters())
        for p in params:
            p.grad = None
        num, den = self.parts_fn(batch)
        num.backward()
        den = torch.clamp(den, min=1.0)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(den)
        return num.detach() / den

    def step(self, state: TrainState
             ) -> Tuple[TrainState, Dict[str, torch.Tensor], RolloutBatch]:
        """One iteration.  Returns ``(state, metrics, batch)``; metrics are
        0-dim tensors on the device (``loss``, ``log_z`` after the update,
        ``mean_log_reward``), read without a host sync."""
        batch = self.sample(state)
        loss = self.loss_and_grads(batch)
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss,
                   "log_z": self.policy.params["log_z"].detach().clone(),
                   "mean_log_reward": batch.log_reward.mean()}
        return state, metrics, batch

    def run(self, seed: int, num_iterations: int, *,
            callback: Optional[Callable] = None, suite=None):
        """Run ``num_iterations`` iterations from a fresh state.  Returns
        ``(state, history)``; history collects ``callback(it, state,
        metrics, batch)`` after every iteration.  An
        :class:`repro_torch.evals.EvalSuite` records its rows after the
        iterations ``it`` with ``it % suite.every == 0`` (``suite.rows()``);
        it reads the parameters and draws noise of its own, so training
        runs the same with and without it."""
        state = self.init(seed)
        history = []
        for it in range(num_iterations):
            state, metrics, batch = self.step(state)
            if suite is not None:
                suite.maybe_record(it)
            if callback is not None:
                history.append(callback(it, state, metrics, batch))
        return state, history
