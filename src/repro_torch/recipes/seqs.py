"""Sequence recipes of the port (port of the bitseq part of
``repro.recipes.seqs``): the env and policy factories shared by serving and
training, and ``bitseq_tb``'s training config."""
from __future__ import annotations

from ..core.policies import TransformerPolicy
from ..core.trainer import GFNConfig
from ..device import DeviceLike
from ..envs.bitseq import BitSeqEnvironment


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
