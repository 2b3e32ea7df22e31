"""Bayesian-network structure-learning recipe of the port (port of
``repro.recipes.dag``; paper §B.4): Modified DB on the DAG environment
(d = 5, BGe score over 100 samples), with the reward correlation over a
uniform probe, the log Z bounds, and the JSD of sampled DAGs against the
exact posterior over all DAGs.

The JAX package's JSD eval hashes each sampled adjacency on the host;
:class:`PosteriorJSDEval` does it on the device: each DAG's code is its
off-diagonal bits in ``enumerate_dags``' order, which enumerates codes in
increasing order, so a sorted search of the sampled codes in the
enumerated ones gives each sample's index.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.policies import MLPPolicy
from ..core.rollout import forward_rollout
from ..core.trainer import GFNConfig
from ..device import DeviceLike
from ..envs.dag import DAGEnvironment
from ..evals import LogZBoundsEval, RewardCorrelationEval, uniform_probe_states
from ..metrics.distributions import empirical_distribution, jensen_shannon
from ..rewards.bayesnet import (BayesNetRewardModule, enumerate_dags,
                                exact_posterior, off_diagonal_pairs)
from .seqs import PROBE_SEED_OFFSET


def dag_env(d: int = 5, score: str = "bge", num_samples: int = 100,
            seed: int = 0) -> DAGEnvironment:
    """The paper's setting: d = 5 nodes, the BGe score of 100 samples of
    a linear-Gaussian network on an Erdos-Renyi DAG drawn from ``seed``."""
    return DAGEnvironment(BayesNetRewardModule(
        d=d, num_samples=num_samples, score=score, seed=seed))


def dag_policy(env: DAGEnvironment, *, seed: int = 0,
               device: DeviceLike = None,
               requires_grad: bool = False) -> MLPPolicy:
    """MLP 2x128 over the flattened adjacency: A forward logits, a learned
    backward head (A_b logits) and a flow head."""
    return MLPPolicy(env.d ** 2, env.action_dim, env.backward_action_dim,
                     hidden=(128, 128), learn_backward=True, seed=seed,
                     device=device, requires_grad=requires_grad)


def dag_config(env: DAGEnvironment, num_envs: int = 128,
               iterations: int = 100000) -> GFNConfig:
    """MDB, lr 1e-4, epsilon 1.0 annealed to 0 over half the iteration
    budget, the stop action last."""
    return GFNConfig(objective="mdb", num_envs=num_envs, lr=1e-4,
                     stop_action=env.stop_action, exploration_eps=1.0,
                     exploration_anneal_steps=iterations // 2)


def dag_evals(env: DAGEnvironment, env_params, policy, *, seed: int = 0,
              eval_batch: int = 2000):
    """The correlation of log P_theta with log R over 128 uniform-policy
    terminals (8 MC samples; rows that ran out of steps take a last stop)
    and the log Z bounds over 256 samples, as the JAX recipe's
    ``make_evals``.  The probe comes from the port's own noise at
    ``seed + 23``."""
    probe, probe_log_r = uniform_probe_states(
        seed + PROBE_SEED_OFFSET, env, env_params, 128,
        stop_action=env.stop_action)
    return [RewardCorrelationEval(env, env_params, policy, probe,
                                  probe_log_r, mc_samples=8),
            LogZBoundsEval(env, env_params, policy, num_samples=256)]


def dag_codes(adj: torch.Tensor) -> torch.Tensor:
    """(..., d, d) adjacency -> (...,) int64 codes: bit b is the edge
    ``off_diagonal_pairs(d)[b]``, the order of ``enumerate_dags``."""
    d = adj.shape[-1]
    weight = torch.zeros((d, d), dtype=torch.int64, device=adj.device)
    for b, (i, j) in enumerate(off_diagonal_pairs(d)):
        weight[i, j] = 1 << b
    return (adj.long() * weight).sum((-2, -1))


class PosteriorJSDEval:
    """``jsd``: Jensen-Shannon divergence between the terminal DAGs of
    ``num_samples`` on-policy rollouts and the exact posterior over all
    DAGs on d nodes (the JAX recipe's ``make_eval``; paper §B.4).  The
    posterior is computed once, in float64 from the float32 table as the
    JAX package does; each call samples, codes, searches and counts on
    the device."""

    metric_names: Tuple[str, ...] = ("jsd",)

    def __init__(self, env: DAGEnvironment, env_params, policy,
                 num_samples: int = 4000):
        self.env, self.env_params, self.policy = env, env_params, policy
        self.num_samples = int(num_samples)
        dev = env_params.device
        dags = enumerate_dags(env.d)
        table = env_params.reward_params["table"].cpu().numpy()
        self.posterior = torch.as_tensor(exact_posterior(dags, table),
                                         dtype=torch.float32, device=dev)
        self.codes = dag_codes(torch.as_tensor(dags, device=dev))

    def indices(self, adj: torch.Tensor) -> torch.Tensor:
        """Each (d, d) adjacency's index in ``enumerate_dags(d)``."""
        return torch.searchsorted(self.codes, dag_codes(adj))

    def jsd(self, adj: torch.Tensor) -> torch.Tensor:
        """The JSD of the histogram of DAGs ``adj`` (N, d, d) against the
        exact posterior."""
        emp = empirical_distribution(self.indices(adj), self.codes.shape[0])
        return jensen_shannon(emp, self.posterior)

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        _, final = forward_rollout(seed, self.env, self.env_params,
                                   self.policy, self.num_samples,
                                   return_final_state=True)
        return {"jsd": self.jsd(final.adj)}
