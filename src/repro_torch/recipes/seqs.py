"""Sequence recipes of the port (port of ``repro.recipes.seqs``; paper
§B.2): bitseq, TFBind8, QM9 and AMP.  For each, the env and policy
factories (bitseq's shared with serving), the training config and the
evaluators.

The correlation evals' uniform probes (TFBind8, QM9, AMP) are drawn from
the port's own rollout noise at ``seed + 23``, where the JAX package draws
them from ``jax.random.PRNGKey(seed + 23)``: an equally distributed probe,
not the same states.  bitseq's probe comes from numpy's ``RandomState``
and is the JAX package's, state for state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.policies import TransformerPolicy
from ..core.rollout import forward_rollout
from ..core.trainer import GFNConfig
from ..device import DeviceLike
from ..envs.bitseq import BitSeqEnvironment
from ..envs.sequences import AMPEnvironment, QM9Environment, TFBind8Environment
from ..evals import (LogZBoundsEval, RewardCorrelationEval,
                     SampledDistributionEval, uniform_probe_states)
from ..metrics.distributions import topk_reward_and_diversity
from ..rewards.bitseq import make_test_set

#: the correlation evals' probe seed offset, as in the JAX package
PROBE_SEED_OFFSET = 23


# -- bit sequences (§B.2) ----------------------------------------------------

def bitseq_env(n: int = 120, k: int = 8, beta: float = 3.0,
               seed: int = 0) -> BitSeqEnvironment:
    """Paper-scale default: n=120, k=8, so L=15 words of m=256 and
    A = 3840 actions."""
    return BitSeqEnvironment(n=n, k=k, beta=beta, seed=seed)


def bitseq_policy(env: BitSeqEnvironment, *, seed: int = 0,
                  device: DeviceLike = None,
                  requires_grad: bool = False) -> TransformerPolicy:
    """The bitseq_tb policy: decode arch, 3 layers, dim 64, 8 heads, MLP
    width 256, readout of A logits + 1 flow head (no learned backward head:
    P_B is uniform)."""
    return TransformerPolicy(env.vocab_size, env.L, env.action_dim,
                             num_layers=3, dim=64, num_heads=8, seed=seed,
                             device=device, requires_grad=requires_grad)


def bitseq_config(env: BitSeqEnvironment, num_envs: int = 16,
                  iterations: int = 50000) -> GFNConfig:
    """``bitseq_tb``'s training config (``repro/recipes/seqs.py:44-46``
    over ``GFNConfig``'s defaults): TB, lr 1e-3, log Z lr 0.1, exploration
    epsilon 1e-3 (not annealed, so the iteration budget is unused)."""
    return GFNConfig(objective="tb", num_envs=num_envs, lr=1e-3,
                     exploration_eps=1e-3)


def bitseq_probe(env: BitSeqEnvironment, env_params, seed: int = 0,
                 test_size: int = 128):
    """The fixed probe of flip-test-set terminals (paper §B.2) and their
    log-rewards: ``test_size`` rows of ``make_test_set(seed, modes)``
    picked by ``RandomState(0)``, as words."""
    modes = env_params.reward_params["modes"].cpu().numpy()
    test = make_test_set(seed, modes)
    sel = np.random.RandomState(0).choice(len(test), test_size,
                                          replace=False)
    pw = 2 ** np.arange(env.k - 1, -1, -1)
    words = (test[sel].reshape(-1, env.L, env.k) * pw).sum(-1)
    term = env.terminal_state_from_words(
        torch.as_tensor(words, device=env_params.device))
    return term, env.log_reward(term, env_params)


def bitseq_evals(env: BitSeqEnvironment, env_params, policy, *,
                 seed: int = 0, eval_batch: int = 2000):
    """The correlation of log P_theta with log R over the flip-test probe
    (10 MC samples) and the log Z bounds over 128 samples; no EUBO (exact
    target samples are out of reach at 2^120 states)."""
    term, log_r = bitseq_probe(env, env_params, seed)
    return [RewardCorrelationEval(env, env_params, policy, term, log_r,
                                  mc_samples=10),
            LogZBoundsEval(env, env_params, policy, num_samples=128)]


# -- TFBind8 and QM9 (§B.2.1): the enumerable target --------------------------

def tfbind8_env() -> TFBind8Environment:
    return TFBind8Environment()


def tfbind8_policy(env: TFBind8Environment, *, seed: int = 0,
                   device: DeviceLike = None,
                   requires_grad: bool = False) -> TransformerPolicy:
    """Decode arch, 2 layers, dim 64, 8 heads, 4 logits + a flow head."""
    return TransformerPolicy(env.vocab_size, env.length, env.action_dim,
                             num_layers=2, dim=64, seed=seed, device=device,
                             requires_grad=requires_grad)


def qm9_env() -> QM9Environment:
    return QM9Environment()


def qm9_policy(env: QM9Environment, *, seed: int = 0,
               device: DeviceLike = None,
               requires_grad: bool = False) -> TransformerPolicy:
    """Pooled arch (the encoder, mean-pooled), 2 layers, dim 64, 8 heads,
    22 logits + a flow head."""
    return TransformerPolicy(env.vocab_size, env.length, env.action_dim,
                             num_layers=2, dim=64, arch="pooled", seed=seed,
                             device=device, requires_grad=requires_grad)


def seq_tb_config(env, num_envs: int = 16,
                  iterations: int = 100000) -> GFNConfig:
    """TFBind8's and QM9's config: TB, lr 5e-4, log Z lr 0.05, epsilon 1.0
    annealed over a fixed 50,000 steps (the paper's baselines; not the
    iteration budget)."""
    return GFNConfig(objective="tb", num_envs=num_envs, lr=5e-4,
                     log_z_lr=0.05, exploration_eps=1.0,
                     exploration_anneal_steps=50000)


def enumerable_evals(env, env_params, policy, *, seed: int = 0,
                     eval_batch: int = 2000):
    """Sampled TV/JSD against softmax(``true_log_rewards``) and hits of
    its 128 top states (a stable sort, as ``jnp.argsort``) over
    ``eval_batch`` samples; the reward correlation over a 128-state
    uniform probe (8 MC samples); the log Z bounds over 256 samples."""
    true = env.true_distribution(env_params)
    modes = torch.argsort(-true, stable=True)[:128]
    probe, probe_log_r = uniform_probe_states(seed + PROBE_SEED_OFFSET, env,
                                              env_params, 128)
    return [SampledDistributionEval(
                env, env_params, policy,
                lambda b: env.flatten_index(b.obs[-1]),
                env.num_terminal_states, true_dist=true, mode_indices=modes,
                num_samples=eval_batch),
            RewardCorrelationEval(env, env_params, policy, probe,
                                  probe_log_r, mc_samples=8),
            LogZBoundsEval(env, env_params, policy, num_samples=256)]


# -- AMP peptides (§B.2.2) ----------------------------------------------------

def amp_env(max_len: int = 60) -> AMPEnvironment:
    return AMPEnvironment(max_len=max_len)


def amp_policy(env: AMPEnvironment, *, seed: int = 0,
               device: DeviceLike = None,
               requires_grad: bool = False) -> TransformerPolicy:
    """Decode arch, 3 layers, dim 64, 8 heads, 21 logits + a flow head,
    log Z starting at 150."""
    return TransformerPolicy(env.vocab_size, env.max_len, env.action_dim,
                             num_layers=3, dim=64, num_heads=8,
                             init_log_z=150.0, seed=seed, device=device,
                             requires_grad=requires_grad)


def amp_config(env: AMPEnvironment, num_envs: int = 16,
               iterations: int = 20000) -> GFNConfig:
    """TB, lr 1e-3, log Z lr 0.64, epsilon 1e-2, the stop action last."""
    return GFNConfig(objective="tb", num_envs=num_envs, lr=1e-3,
                     log_z_lr=0.64, exploration_eps=1e-2,
                     stop_action=env.stop_action)


def amp_evals(env: AMPEnvironment, env_params, policy, *, seed: int = 0,
              eval_batch: int = 2000):
    """The reward correlation over a 64-state uniform probe (each row
    stopped, 4 MC samples) and the log Z bounds over 128 samples."""
    probe, probe_log_r = uniform_probe_states(
        seed + PROBE_SEED_OFFSET, env, env_params, 64,
        stop_action=env.stop_action)
    return [RewardCorrelationEval(env, env_params, policy, probe,
                                  probe_log_r, mc_samples=4),
            LogZBoundsEval(env, env_params, policy, num_samples=128)]


def amp_eval(env: AMPEnvironment, env_params, policy,
             num_samples: int = 256, k: int = 100):
    """``eval_fn(seed) -> {"top100_reward", "diversity"}``: the mean
    reward of the top ``k`` of ``num_samples`` on-policy samples and their
    mean pairwise Hamming distance (paper Fig. 5)."""
    def eval_fn(seed: int):
        b = forward_rollout(seed, env, env_params, policy, num_samples)
        r, d = topk_reward_and_diversity(torch.exp(b.log_reward), b.obs[-1],
                                         k=k)
        return {"top100_reward": float(r), "diversity": float(d)}

    return eval_fn
