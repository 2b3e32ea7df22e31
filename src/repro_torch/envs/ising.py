"""Ising-model environment (port of ``repro.envs.ising``; paper §3.8 /
§B.5, after Zhang et al. 2022).

States are partial spin assignments s in {-1, +1, 0 (unassigned)}^D with
D = N^2 lattice sites.  A forward action picks an unassigned site and sets
its spin: action = 2 * site + (spin + 1) / 2.  Terminal after D steps.
Backward actions remove the spin at a site (D of them).

Reward: the Gibbs distribution of E_J(x) = -x^T J x, so log R(x) = x^T J x.
In EB-GFN (:mod:`repro_torch.core.ebgfn`) J is the energy model's learned
parameter, and the loop hands each rollout the params of the J it holds.

A step writes one site per row with ``scatter`` on a copy of the spins: a
device op with no host read, so rollouts over this env capture in a CUDA
graph.

The MCMC dataset samplers are the JAX package's numpy code, verbatim, on a
``numpy.random.RandomState``: :func:`generate_ising_dataset` returns JAX's
samples bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .base import Environment


def toroidal_adjacency(n: int) -> np.ndarray:
    """Adjacency A_N of the N x N toroidal lattice, shape (N^2, N^2)."""
    D = n * n
    A = np.zeros((D, D), np.float32)
    for r in range(n):
        for c in range(n):
            i = r * n + c
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                j = ((r + dr) % n) * n + (c + dc) % n
                A[i, j] = 1.0
    return A


@dataclasses.dataclass(frozen=True)
class IsingState:
    spins: torch.Tensor      # (B, D) int8 in {-1, 0, +1}
    steps: torch.Tensor      # (B,) int32


@dataclasses.dataclass(frozen=True)
class IsingParams:
    reward_params: Dict[str, torch.Tensor]    # {"J": (D, D) float32}

    @property
    def device(self) -> torch.device:
        return self.reward_params["J"].device


class IsingGibbsRewardModule:
    """Gibbs reward log R(x) = x^T J x with the toroidal coupling
    J = sigma * A_N; the module scores whatever ``params["J"]`` holds."""

    def __init__(self, n: int = 9, sigma: float = -0.1):
        self.n, self.sigma = n, sigma

    def init(self, device: torch.device) -> Dict[str, torch.Tensor]:
        J = self.sigma * toroidal_adjacency(self.n)
        return {"J": torch.as_tensor(J, dtype=torch.float32, device=device)}

    @staticmethod
    def log_reward(spins: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = spins.to(torch.float32)
        return ((x @ params["J"]) * x).sum(-1)


class IsingEnvironment(Environment):

    def __init__(self, n: int = 9, sigma: float = -0.1):
        self.n, self.sigma = n, sigma
        self.D = n * n
        self.reward_module = IsingGibbsRewardModule(n, sigma)
        self.action_dim = 2 * self.D
        self.backward_action_dim = self.D
        self.max_steps = self.D

    def init(self, device: DeviceLike = None) -> IsingParams:
        """The true coupling J = sigma * A_N (the reward module's)."""
        return IsingParams(
            reward_params=self.reward_module.init(resolve_device(device)))

    def reset(self, num_envs: int, params: IsingParams
              ) -> Tuple[torch.Tensor, IsingState]:
        dev = params.device
        state = IsingState(
            spins=torch.zeros((num_envs, self.D), dtype=torch.int8,
                              device=dev),
            steps=torch.zeros((num_envs,), dtype=torch.int32, device=dev))
        return self.observe(state, params), state

    def _forward(self, state: IsingState, action: torch.Tensor,
                 params: IsingParams) -> IsingState:
        action = action.long()
        spin = (2 * (action % 2) - 1).to(torch.int8)
        spins = state.spins.clone().scatter_(1, (action // 2)[:, None],
                                             spin[:, None])
        return IsingState(spins=spins, steps=state.steps + 1)

    def _backward(self, state: IsingState, action: torch.Tensor,
                  params: IsingParams) -> IsingState:
        spins = state.spins.clone().scatter_(1, action.long()[:, None], 0)
        return IsingState(spins=spins,
                          steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: IsingState, params) -> torch.Tensor:
        return state.steps >= self.D

    def log_reward(self, state: IsingState,
                   params: IsingParams) -> torch.Tensor:
        # the zeros of a partial state add nothing to x^T J x
        return self.reward_module.log_reward(state.spins,
                                             params.reward_params)

    def energy(self, state: IsingState, params: IsingParams) -> torch.Tensor:
        """Forward-looking energy E(s) = -s^T J s, E(s0) = 0."""
        return -self.log_reward(state, params)

    def observe(self, state: IsingState, params) -> torch.Tensor:
        return state.spins.to(torch.float32)

    def forward_mask(self, state: IsingState, params) -> torch.Tensor:
        """Action 2 * site + b is legal where the site is unassigned: each
        site's flag twice in a row (JAX's ``repeat(.., 2, axis=-1)``, not
        a tiling)."""
        free = state.spins == 0
        return free[:, :, None].expand(-1, -1, 2).reshape(free.shape[0], -1)

    def backward_mask(self, state: IsingState, params) -> torch.Tensor:
        return state.spins != 0

    def get_backward_action(self, state, action, next_state, params):
        return action.long() // 2

    def get_forward_action(self, state: IsingState, bwd_action: torch.Tensor,
                           prev_state, params) -> torch.Tensor:
        """int64, as the sampled actions are.  The spin is widened before
        ``(spin + 1) // 2``; at an initial state's dummy row it is 0, which
        gives 0, as in JAX."""
        bwd_action = bwd_action.long()
        spin = torch.gather(state.spins, 1, bwd_action[:, None])[:, 0].long()
        return 2 * bwd_action + torch.div(spin + 1, 2, rounding_mode="floor")

    def terminal_state_from_spins(self, spins: torch.Tensor) -> IsingState:
        B = spins.shape[0]
        return IsingState(spins=spins.to(torch.int8),
                          steps=torch.full((B,), self.D, dtype=torch.int32,
                                           device=spins.device))


# ---------------------------------------------------------------------------
# MCMC dataset generation (paper §B.5: Wolff + heat-bath parallel tempering)
# ---------------------------------------------------------------------------

def wolff_samples(rng: np.random.RandomState, n: int, sigma: float,
                  num_samples: int, thin: int = 5,
                  burn_in: int = 200) -> np.ndarray:
    """Wolff cluster sampler for J = sigma * A_N (ferromagnetic sigma > 0).

    P(x) ∝ exp(x^T J x): pairwise coupling K = 2*sigma per lattice bond
    (each bond appears twice in x^T J x); cluster add-probability
    p = 1 - exp(-2K) for aligned neighbours.
    """
    D = n * n
    p_add = 1.0 - np.exp(-4.0 * abs(sigma))
    spins = rng.choice([-1, 1], size=D).astype(np.int8)
    neigh = _neighbor_table(n)
    out = np.zeros((num_samples, D), np.int8)
    it = 0
    collected = 0
    while collected < num_samples:
        seed_site = rng.randint(D)
        cluster = {seed_site}
        frontier = [seed_site]
        s0 = spins[seed_site]
        while frontier:
            site = frontier.pop()
            for nb in neigh[site]:
                if nb not in cluster and spins[nb] == s0 \
                        and rng.rand() < p_add:
                    cluster.add(nb)
                    frontier.append(nb)
        idx = np.fromiter(cluster, dtype=np.int64)
        spins[idx] = -spins[idx]
        it += 1
        if it > burn_in and it % thin == 0:
            out[collected] = spins
            collected += 1
    return out


def _neighbor_table(n: int):
    tbl = []
    for r in range(n):
        for c in range(n):
            tbl.append([((r + dr) % n) * n + (c + dc) % n
                        for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0))])
    return tbl


def heatbath_pt_samples(rng: np.random.RandomState, n: int, sigma: float,
                        num_samples: int, num_chains: int = 8,
                        sweeps_per_sample: int = 4,
                        burn_in_sweeps: int = 300) -> np.ndarray:
    """Heat-bath parallel tempering (paper's sampler for frustrated /
    antiferromagnetic couplings).  Temperature ladder geometric in [1, 4].
    """
    D = n * n
    A = toroidal_adjacency(n)
    J = sigma * A
    betas = 1.0 / np.geomspace(1.0, 4.0, num_chains)
    spins = rng.choice([-1, 1], size=(num_chains, D)).astype(np.int8)
    out = np.zeros((num_samples, D), np.int8)

    def sweep():
        for c in range(num_chains):
            order = rng.permutation(D)
            for site in order:
                field = 2.0 * float(J[site] @ spins[c])  # dE of flip
                p_up = 1.0 / (1.0 + np.exp(-2.0 * betas[c] * field))
                spins[c, site] = 1 if rng.rand() < p_up else -1
        # neighbour swaps
        for c in range(num_chains - 1):
            e1 = -float(spins[c] @ J @ spins[c])
            e2 = -float(spins[c + 1] @ J @ spins[c + 1])
            if rng.rand() < np.exp((betas[c] - betas[c + 1]) * (e1 - e2)):
                spins[[c, c + 1]] = spins[[c + 1, c]]

    for _ in range(burn_in_sweeps):
        sweep()
    for s in range(num_samples):
        for _ in range(sweeps_per_sample):
            sweep()
        out[s] = spins[0]
    return out


def generate_ising_dataset(seed: int, n: int, sigma: float,
                           num_samples: int = 2000) -> np.ndarray:
    """Paper §B.5: Wolff for ferromagnetic couplings, heat-bath PT otherwise;
    (num_samples, n * n) int8 spins."""
    rng = np.random.RandomState(seed)
    if sigma > 0:
        return wolff_samples(rng, n, sigma, num_samples)
    return heatbath_pt_samples(rng, n, sigma, num_samples)
