"""Exact terminal distributions of the learned policy by dynamic
programming (port of ``repro.evals.exact``; paper §B.1 exact-TV curves):
the hypergrid's and a small bitseq's.

For an enumerable environment the terminal distribution

    P_theta(x) = sum_{tau -> x} prod_t P_F(a_t | s_t)

follows by propagating probability mass through the state DAG in
topological order, with one batched policy evaluation over all states: the
true TV/JSD to the target, without the sampling floor of a histogram.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.types import masked_logprobs
from ..envs.bitseq import BitSeqEnvironment, BitSeqState
from ..envs.hypergrid import HypergridEnvironment, HypergridState
from ..metrics.distributions import jensen_shannon, total_variation

#: refuse to enumerate state spaces beyond this size (DP memory is O(N * A))
MAX_ENUM_STATES = 1_000_000


def make_hypergrid_dp(env: HypergridEnvironment, env_params,
                      policy) -> Callable[[], torch.Tensor]:
    """Returns ``dp() -> (side**dim,)``: the terminal distribution of
    ``policy``'s current parameters over content states, flat C-order (the
    order of ``env.flatten_index`` and ``env.true_distribution``).

    Mass moves level by level along the coordinate-sum grading of the DAG:
    at each of the ``dim*(side-1)+1`` levels every state sheds
    ``P(stop | s)`` into its terminal copy and routes ``P(a_j | s)`` to its
    axis-j successor (a shift of the mass grid; the wrapped slice is zero
    because the mask forbids incrementing at ``side - 1``)."""
    dim, side = env.dim, env.side
    N = side ** dim
    if N > MAX_ENUM_STATES:
        raise ValueError(f"hypergrid has {N} states > {MAX_ENUM_STATES}; "
                         "use a sampling evaluator instead")
    shape = (side,) * dim
    grids = env.all_positions(env_params.device)
    states = HypergridState(
        pos=grids, terminal=torch.zeros(N, dtype=torch.bool,
                                        device=grids.device),
        steps=grids.sum(-1, dtype=torch.int32))
    obs = env.observe(states, env_params)
    fmask = env.forward_mask(states, env_params)
    num_levels = dim * (side - 1) + 1

    @torch.no_grad()
    def dp() -> torch.Tensor:
        logits = policy.apply(obs)["logits"]
        probs = torch.exp(masked_logprobs(logits, fmask)) * fmask
        stop_p = probs[:, dim].reshape(shape)
        move_p = probs[:, :dim].reshape(shape + (dim,))
        p = torch.zeros(shape, dtype=torch.float32, device=obs.device)
        p[(0,) * dim] = 1.0
        p_term = torch.zeros_like(p)
        for _ in range(num_levels):
            p_term = p_term + p * stop_p
            nxt = torch.zeros_like(p)
            for j in range(dim):
                nxt = nxt + torch.roll(p * move_p[..., j], 1, dims=j)
            p = nxt
        flat = p_term.reshape(N)
        return flat / torch.clamp(flat.sum(), min=1e-9)

    return dp


def make_bitseq_dp(env: BitSeqEnvironment, env_params,
                   policy) -> Callable[[], torch.Tensor]:
    """Returns ``dp() -> (m**L,)``: the terminal distribution of
    ``policy``'s current parameters over full word sequences, flat base-m
    C-order (word 0 most significant).

    The non-autoregressive DAG is graded by fill count: partial states sit
    at base-(m+1) indices (empty token = m), and writing word w at empty
    position p moves the index by ``(w - m) * (m+1)**(L-1-p)``, an offset
    that does not depend on the state, so one scatter-add per level moves
    every transition."""
    L, m = env.L, env.m
    base = m + 1
    Np = base ** L
    if Np > MAX_ENUM_STATES:
        raise ValueError(f"bitseq has {Np} partial states > "
                         f"{MAX_ENUM_STATES}; use a sampling evaluator")
    dev = env_params.device
    tokens = np.stack(np.meshgrid(*[np.arange(base)] * L, indexing="ij"),
                      axis=-1).reshape(-1, L).astype(np.int32)
    filled = (tokens != m).sum(-1).astype(np.int32)
    states = BitSeqState(tokens=torch.as_tensor(tokens, device=dev),
                         steps=torch.as_tensor(filled, device=dev))
    obs = env.observe(states, env_params)
    fmask = env.forward_mask(states, env_params)             # (Np, L*m)
    delta = np.array([(w - m) * base ** (L - 1 - p)
                      for p in range(L) for w in range(m)], np.int64)
    # an illegal action's target may leave the index range; its mass is 0
    next_idx = torch.as_tensor(
        np.clip(np.arange(Np, dtype=np.int64)[:, None] + delta[None, :],
                0, Np - 1).reshape(-1), device=dev)
    init_idx = int((base ** L - 1) // (base - 1) * m)       # all empty
    full = filled == L
    pw = m ** np.arange(L - 1, -1, -1)
    word_idx = torch.as_tensor((np.where(full[:, None], tokens, 0) * pw)
                               .sum(-1), device=dev)
    full = torch.as_tensor(full, device=dev)

    @torch.no_grad()
    def dp() -> torch.Tensor:
        logits = policy.apply(obs)["logits"]
        probs = torch.exp(masked_logprobs(logits, fmask)) * fmask
        p = torch.zeros(Np, dtype=torch.float32, device=dev)
        p[init_idx] = 1.0
        for _ in range(L):
            p = torch.zeros_like(p).index_add_(
                0, next_idx, (p[:, None] * probs).reshape(-1))
        flat = torch.zeros(m ** L, dtype=torch.float32,
                           device=dev).index_add_(
            0, word_idx, torch.where(full, p, 0.0))
        return flat / torch.clamp(flat.sum(), min=1e-9)

    return dp


def make_exact_dp(env, env_params, policy) -> Callable[[], torch.Tensor]:
    """The DP builder of the environment's type; a wrapped env (a reward
    transform) dispatches on the env it wraps."""
    bare = env
    while hasattr(bare, "env"):
        bare = bare.env
    if isinstance(bare, HypergridEnvironment):
        return make_hypergrid_dp(env, env_params, policy)
    if isinstance(bare, BitSeqEnvironment):
        return make_bitseq_dp(env, env_params, policy)
    raise TypeError(f"no exact-DP evaluator for {type(bare).__name__}; "
                    "enumerable envs: Hypergrid, BitSeq")


class ExactDistributionEval:
    """``exact_tv`` / ``exact_jsd`` of the DP-computed terminal distribution
    against the true target R(x)/Z (paper Eq. 15 and Figs. 2/4, without
    sampling error).  Draws no noise."""

    metric_names: Tuple[str, ...] = ("exact_tv", "exact_jsd")

    def __init__(self, env, env_params, policy,
                 true_dist: Optional[torch.Tensor] = None):
        self.dp = make_exact_dp(env, env_params, policy)
        self.true = (true_dist if true_dist is not None
                     else env.true_distribution(env_params))

    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        dist = self.dp()
        return {"exact_tv": total_variation(dist, self.true),
                "exact_jsd": jensen_shannon(dist, self.true)}
