"""Hypergrid recipes of the port (port of ``repro.recipes.hypergrid``;
paper §B.1): TB, DB and SubTB with the exact-DP TV/JSD against the
closed-form target, sampled TV/JSD with mode hits, and the ELBO/EUBO log Z
bounds.

The default grid is 8^4 (4,096 states), where the exact terminal
distribution of the learned policy is cheap to compute every eval; the
paper's 20^4 grid is ``--set side=20``.
"""
from __future__ import annotations

import torch

from ..core.policies import MLPPolicy
from ..core.trainer import GFNConfig
from ..device import DeviceLike, cpu_generator
from ..envs.hypergrid import HypergridEnvironment
from ..evals import (ExactDistributionEval, LogZBoundsEval,
                     SampledDistributionEval)
from ..rewards.hypergrid import HypergridRewardModule

#: exact DP is O(states); above this only the sampling evals run
_EXACT_DP_MAX_STATES = 200_000
#: states counted as modes: the top slice of the true distribution
_NUM_MODES = 64
#: probe terminals drawn from the true distribution for the EUBO bound
_EUBO_PROBE = 512


def hypergrid_env(dim: int = 4, side: int = 8) -> HypergridEnvironment:
    return HypergridEnvironment(HypergridRewardModule(), dim=dim, side=side)


def hypergrid_policy(env: HypergridEnvironment, *, seed: int = 0,
                     device: DeviceLike = None,
                     requires_grad: bool = False) -> MLPPolicy:
    """MLP 2x256 with A forward logits and a flow head (uniform P_B)."""
    return MLPPolicy(env.obs_dim, env.action_dim, env.backward_action_dim,
                     hidden=(256, 256), seed=seed, device=device,
                     requires_grad=requires_grad)


def hypergrid_config(objective: str):
    def make_config(env: HypergridEnvironment, num_envs: int = 16,
                    iterations: int = 20000) -> GFNConfig:
        """lr 1e-3, log Z lr 0.1, epsilon 0.1 annealed to 0 over half the
        iteration budget, the stop action last."""
        return GFNConfig(objective=objective, num_envs=num_envs, lr=1e-3,
                         log_z_lr=1e-1, stop_action=env.dim,
                         exploration_eps=0.1,
                         exploration_anneal_steps=iterations // 2)
    return make_config


def terminal_index_fn(env: HypergridEnvironment):
    """``batch -> (B,)`` flat indices of the batch's final states."""
    def index_fn(batch):
        pos = torch.argmax(batch.obs[-1].reshape(-1, env.dim, env.side), -1)
        return env.flatten_index(pos)
    return index_fn


def hypergrid_evals(env: HypergridEnvironment, env_params, policy, *,
                    seed: int = 0, eval_batch: int = 2000):
    """The recipe's evaluators; ``eval_batch`` samples for the sampled
    ones.  Modes are the first ``_NUM_MODES`` states of a stable descending
    sort of the target, which is full of exact ties (an unstable sort picks
    another set).  The EUBO probe is ``_EUBO_PROBE`` flat indices drawn
    from the target with a CPU generator seeded ``seed + 17`` (the JAX
    package draws its own with ``jax.random``)."""
    num_states = env.side ** env.dim
    true = env.true_distribution(env_params)
    modes = torch.argsort(-true, stable=True)[:min(_NUM_MODES, num_states)]
    evals = []
    if num_states <= _EXACT_DP_MAX_STATES:
        evals.append(ExactDistributionEval(env, env_params, policy,
                                           true_dist=true))
    evals.append(SampledDistributionEval(
        env, env_params, policy, terminal_index_fn(env), num_states,
        true_dist=true, mode_indices=modes, num_samples=eval_batch))
    probe_idx = torch.multinomial(true.cpu(), _EUBO_PROBE, replacement=True,
                                  generator=cpu_generator(seed + 17))
    probe = env.terminal_state_from_flat_index(probe_idx.to(true.device))
    evals.append(LogZBoundsEval(
        env, env_params, policy, num_samples=256, target_states=probe,
        target_log_r=env.log_reward(probe, env_params)))
    return evals
