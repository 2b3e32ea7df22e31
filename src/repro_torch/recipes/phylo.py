"""Phylogenetic-tree recipe of the port (port of ``repro.recipes.phylo``;
paper §B.3): Forward-Looking DB on DS1 (27 species x 1,949 sites) with
the 6-layer slot transformer, and the correlation of log P_theta with
log R over uniformly sampled trees (the paper's Fig. 6 metric).
"""
from __future__ import annotations

from ..core.policies import PhyloPolicy
from ..core.trainer import GFNConfig
from ..device import DeviceLike
from ..envs.phylo import PhyloEnvironment
from ..evals import RewardCorrelationEval, uniform_probe_states
from .seqs import PROBE_SEED_OFFSET


def phylo_env(ds: int = 1, reduced: bool = False,
              seed: int = 0) -> PhyloEnvironment:
    """Dataset ``ds``'s dimensions and reward constant (alignment seed
    ``seed + 100 * ds``); ``reduced=True`` is the 10-species, 100-site
    alignment of CPU smoke runs."""
    if reduced:
        return PhyloEnvironment(n_species=10, n_sites=100, reward_c=100.0,
                                seed=seed)
    return PhyloEnvironment.from_dataset(ds, seed=seed)


def phylo_policy(env: PhyloEnvironment, *, seed: int = 0,
                 device: DeviceLike = None,
                 requires_grad: bool = False) -> PhyloPolicy:
    """6 encoder layers, dim 32, 8 heads, MLP width 128 (paper Table 6)."""
    return PhyloPolicy(env, num_layers=6, seed=seed, device=device,
                       requires_grad=requires_grad)


def phylo_config(env: PhyloEnvironment, num_envs: int = 32,
                 iterations: int = 100000) -> GFNConfig:
    """FLDB, lr 3e-4 (log Z lr 0.1, unused by FLDB), epsilon 1.0 annealed
    to 0 over half the iteration budget; no stop action."""
    return GFNConfig(objective="fldb", num_envs=num_envs, lr=3e-4,
                     exploration_eps=1.0,
                     exploration_anneal_steps=iterations // 2)


def phylo_evals(env: PhyloEnvironment, env_params, policy, *,
                seed: int = 0, eval_batch: int = 2000):
    """The correlation over 64 uniform-policy trees (8 MC samples under
    the learned P_B): a trained sampler's own trees have nearly equal
    parsimony.  The probe comes from the port's own noise at
    ``seed + 23``."""
    probe, probe_log_r = uniform_probe_states(
        seed + PROBE_SEED_OFFSET, env, env_params, 64)
    return [RewardCorrelationEval(env, env_params, policy, probe,
                                  probe_log_r, mc_samples=8)]
