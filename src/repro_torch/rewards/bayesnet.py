"""Bayesian-network structure scores (port of ``repro.rewards.bayesnet``;
paper §B.4).

The dataset, the local-score tables and the exact posterior are numpy
float64, copied from the JAX package line for line, so the port draws the
same data from the same ``RandomState`` and computes the same tables, bit
for bit.  Two modular scores:

  - linear-Gaussian (Bayesian linear-regression evidence per node);
  - BGe (Geiger & Heckerman 1994, the Kuipers-Moffa parameterization with
    alpha_mu, alpha_w, T = t*I).

Both decompose as log R(G) = sum_j LocalScore(X_j | Pa_G(X_j)) (Eq. 12):
adding u -> v changes only v's term (the delta score, Eq. 13).  The
``(d, 2^d)`` table of LocalScore(j | parent bitmask) is what the DAG
environment reads on the device, in float32.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_LGAMMA = np.vectorize(math.lgamma)


# -- dataset generation (paper Eq. 14) ---------------------------------------

def sample_erdos_renyi_dag(rng: np.random.RandomState, d: int,
                           expected_in_degree: float = 1.0) -> np.ndarray:
    """Upper-triangular-under-random-permutation ER DAG."""
    p = min(1.0, expected_in_degree * 2.0 / max(d - 1, 1))
    perm = rng.permutation(d)
    adj = np.zeros((d, d), np.int8)
    for i in range(d):
        for j in range(i + 1, d):
            if rng.rand() < p:
                adj[perm[i], perm[j]] = 1
    return adj


def sample_linear_gaussian_data(rng: np.random.RandomState, adj: np.ndarray,
                                num_samples: int = 100,
                                noise_var: float = 0.1) -> np.ndarray:
    """Ancestral sampling with w_ij ~ N(0,1), sigma^2 = noise_var."""
    d = adj.shape[0]
    W = rng.randn(d, d) * adj
    order = topological_order(adj)
    X = np.zeros((num_samples, d))
    for j in order:
        mean = X @ W[:, j]
        X[:, j] = mean + math.sqrt(noise_var) * rng.randn(num_samples)
    return X


def topological_order(adj: np.ndarray) -> list:
    d = adj.shape[0]
    in_deg = adj.sum(0).astype(int)
    order, stack = [], [j for j in range(d) if in_deg[j] == 0]
    while stack:
        u = stack.pop()
        order.append(u)
        for v in range(d):
            if adj[u, v]:
                in_deg[v] -= 1
                if in_deg[v] == 0:
                    stack.append(v)
    if len(order) != d:
        raise ValueError("graph has a cycle")
    return order


# -- local-score tables --------------------------------------------------------

def _parent_indices(mask: int, d: int) -> list:
    return [i for i in range(d) if (mask >> i) & 1]


def linear_gaussian_score_table(X: np.ndarray, noise_var: float = 0.1,
                                prior_var: float = 1.0) -> np.ndarray:
    """(d, 2^d) table of Bayesian linear-regression log evidences:
    y_j | X_S ~ N(0, prior_var * X_S X_S^T + noise_var * I), evaluated in
    the parent dimension through the Woodbury identity; -inf where j is
    its own parent."""
    N, d = X.shape
    table = np.full((d, 2 ** d), -np.inf)
    for j in range(d):
        y = X[:, j]
        yy = float(y @ y)
        for mask in range(2 ** d):
            if (mask >> j) & 1:
                continue
            S = _parent_indices(mask, d)
            p = len(S)
            if p == 0:
                logdet = N * math.log(noise_var)
                quad = yy / noise_var
            else:
                Xs = X[:, S]
                G = Xs.T @ Xs
                A = np.eye(p) + (prior_var / noise_var) * G
                sign, ld = np.linalg.slogdet(A)
                logdet = N * math.log(noise_var) + ld
                b = Xs.T @ y
                quad = (yy - (prior_var / noise_var)
                        * float(b @ np.linalg.solve(A, b))) / noise_var
            table[j, mask] = -0.5 * (N * math.log(2 * math.pi)
                                     + logdet + quad)
    return table


def bge_score_table(X: np.ndarray, alpha_mu: float = 1.0,
                    alpha_w: float | None = None) -> np.ndarray:
    """(d, 2^d) BGe local scores (score-equivalent: Markov-equivalent DAGs
    get the same total); -inf where j is its own parent."""
    N, d = X.shape
    if alpha_w is None:
        alpha_w = d + 2.0
    t = alpha_mu * (alpha_w - d - 1.0) / (alpha_mu + 1.0)
    xbar = X.mean(0)
    Xc = X - xbar
    R = t * np.eye(d) + Xc.T @ Xc \
        + (N * alpha_mu / (N + alpha_mu)) * np.outer(xbar, xbar)

    def logdet_sub(idx):
        if len(idx) == 0:
            return 0.0
        sub = R[np.ix_(idx, idx)]
        sign, ld = np.linalg.slogdet(sub)
        return float(ld)

    table = np.full((d, 2 ** d), -np.inf)
    for j in range(d):
        for mask in range(2 ** d):
            if (mask >> j) & 1:
                continue
            S = _parent_indices(mask, d)
            p = len(S)
            const = (0.5 * (math.log(alpha_mu) - math.log(N + alpha_mu))
                     + _LGAMMA(0.5 * (N + alpha_w - d + p + 1))
                     - _LGAMMA(0.5 * (alpha_w - d + p + 1))
                     - 0.5 * N * math.log(math.pi)
                     + 0.5 * (alpha_w - d + 2 * p + 1) * math.log(t))
            ld_P = logdet_sub(S)
            ld_Q = logdet_sub(S + [j])
            table[j, mask] = (const
                              + 0.5 * (N + alpha_w - d + p) * ld_P
                              - 0.5 * (N + alpha_w - d + p + 1) * ld_Q)
    return table


# -- the exact posterior by enumeration (29,281 DAGs at d = 5) ----------------

def off_diagonal_pairs(d: int) -> list:
    """The (i, j), i != j, in row-major order: bit b of a DAG's code is
    the edge ``off_diagonal_pairs(d)[b]``."""
    return [(i, j) for i in range(d) for j in range(d) if i != j]


def enumerate_dags(d: int) -> np.ndarray:
    """All DAG adjacency matrices over d labelled nodes, (n_dags, d, d)
    int8, in increasing order of their code (bit b = the b-th pair of
    :func:`off_diagonal_pairs`): the 2^(d(d-1)) codes in chunks, kept
    where the adjacency matrix is nilpotent.  d <= 5 is the paper's
    setting."""
    off = off_diagonal_pairs(d)
    n_bits = len(off)
    n_total = 1 << n_bits
    keep = []
    chunk = 1 << 16
    for lo in range(0, n_total, chunk):
        ids = np.arange(lo, min(lo + chunk, n_total), dtype=np.int64)
        A = np.zeros((ids.size, d, d), np.float32)
        for b, (i, j) in enumerate(off):
            A[:, i, j] = (ids >> b) & 1
        M = A.copy()
        acyclic = np.ones(ids.size, bool)
        for _ in range(d - 1):
            acyclic &= (np.einsum('bii->b', M) == 0)
            M = (M @ A > 0).astype(np.float32)
        acyclic &= (np.einsum('bii->b', M) == 0)
        keep.append(A[acyclic].astype(np.int8))
    return np.concatenate(keep, axis=0)


def dag_log_scores(dags: np.ndarray, table: np.ndarray) -> np.ndarray:
    """log R(G) per enumerated DAG from a local-score table."""
    n, d, _ = dags.shape
    pw = (1 << np.arange(d)).astype(np.int64)
    masks = (dags.astype(np.int64) * pw[:, None]).sum(1)  # (n, d) col masks
    out = np.zeros(n)
    for j in range(d):
        out += table[j, masks[:, j]]
    return out


def exact_posterior(dags: np.ndarray, table: np.ndarray) -> np.ndarray:
    ls = dag_log_scores(dags, table)
    ls = ls - ls.max()
    p = np.exp(ls)
    return p / p.sum()


# -- structural-feature marginals (paper Eqs. 16-18) ----------------------------

def edge_marginals(dags: np.ndarray, post: np.ndarray) -> np.ndarray:
    return np.einsum('n,nij->ij', post, dags.astype(np.float64))


def path_marginals(dags: np.ndarray, post: np.ndarray) -> np.ndarray:
    d = dags.shape[1]
    reach = dags.astype(np.float64)
    closure = reach.copy()
    for _ in range(d - 1):
        closure = np.minimum(closure + np.matmul(closure, reach), 1.0)
    return np.einsum('n,nij->ij', post, closure)


def markov_blanket_marginals(dags: np.ndarray,
                             post: np.ndarray) -> np.ndarray:
    A = dags.astype(np.float64)
    parent = np.transpose(A, (0, 2, 1))
    child = A
    coparent = np.minimum(np.matmul(A, np.transpose(A, (0, 2, 1))), 1.0)
    mb = np.minimum(parent + child + coparent, 1.0)
    for b in range(mb.shape[0]):
        np.fill_diagonal(mb[b], 0.0)
    return np.einsum('n,nij->ij', post, mb)


class BayesNetRewardModule:
    """The dataset and its score table, as the DAG environment's reward
    parameters.  log R(G) = sum_j LocalScore(j | Pa(j)) is a d-term lookup
    of the per-node parent bitmasks ``pa_mask`` (B, d) int32 (Eq. 12)."""

    def __init__(self, d: int = 5, num_samples: int = 100,
                 score: str = "bge", seed: int = 0):
        if score not in ("bge", "lingauss"):
            raise ValueError(f"unknown score {score!r}")
        self.d = d
        self.num_samples = num_samples
        self.score = score
        self.seed = seed

    def dataset(self):
        """``(true_adj int8 (d, d), data float64 (num_samples, d))`` from
        ``RandomState(seed)``, as the JAX package draws them."""
        rng = np.random.RandomState(self.seed)
        adj = sample_erdos_renyi_dag(rng, self.d)
        X = sample_linear_gaussian_data(rng, adj, self.num_samples)
        return adj, X

    def init(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """``table`` (d, 2^d) float32, ``empty_score`` (the empty graph's
        log R: the float64 sum of column 0, then float32), ``true_adj``
        int8 and ``data`` float32, on ``device``."""
        dev = resolve_device(device)
        adj, X = self.dataset()
        table = (bge_score_table(X) if self.score == "bge"
                 else linear_gaussian_score_table(X))
        return {
            "table": torch.as_tensor(table.astype(np.float32), device=dev),
            "empty_score": torch.tensor(float(np.float32(table[:, 0].sum())),
                                        dtype=torch.float32, device=dev),
            "true_adj": torch.as_tensor(adj, device=dev),
            "data": torch.as_tensor(X.astype(np.float32), device=dev),
        }

    def log_reward(self, pa_mask: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The modular score read directly from the parent bitmasks; the
        environment's steps carry it incrementally (Eq. 13) and agree."""
        node = torch.arange(pa_mask.shape[-1], device=pa_mask.device)
        return params["table"][node, pa_mask.long()].sum(-1)
