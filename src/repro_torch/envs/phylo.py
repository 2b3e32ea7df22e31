"""Phylogenetic-tree generation environment (port of ``repro.envs.phylo``;
paper §3.6 / §B.3, PhyloGFN).

From a forest of n singleton species, each step merges two root trees
under a new common ancestor; after n-1 merges one rooted binary tree is
left.  Parsimony is kept incrementally with Fitch's algorithm over 4-bit
character-state masks: merging roots with Fitch sets a and b gives
``a & b`` where that is non-empty, else ``a | b`` and one mutation at the
site.  The mutation count M(s) gives the terminal reward
log R(x) = (C - M(x)) / alpha and the FLDB energy
E(s) = (M(s) - C * merges / (n-1)) / alpha, with E(s0) = 0 and
E(x) = -log R(x).

Slots: 2n-1 node slots (leaves 0..n-1; a merge fills the first empty
internal slot).  A forward action is a slot pair i < j; a backward action
the internal root to split.

Every write is an elementwise select against a one-hot of the slot, not
an indexed write into the (B, 2n-1, S) uint8 Fitch sets, and every
constant the steps divide by is a float32 tensor on the device (CUDA
turns a division by a Python float into a product with its reciprocal),
so a step has no host read, captures in a CUDA graph, and gives the CPU's
bits.  The observation's histogram of Fitch values is carried in the
state as counts (``node_hist``, (B, 2n-1, 15) int32): a merge counts the
15 values over the new node's S sites only, a split zeroes the node's
row, where the JAX package averages a float32 one-hot of 16 over every
node's sites at every observation.  The counts are exact, so the
histogram is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .base import Environment

#: (species, sites) of the 8 PhyloGFN benchmark alignments
DS_DIMS = {
    1: (27, 1949), 2: (29, 2520), 3: (36, 1812), 4: (41, 1137),
    5: (50, 378), 6: (50, 1133), 7: (59, 1824), 8: (64, 1008),
}
#: paper Table 6 reward constants C per dataset
DS_REWARD_C = {1: 5800., 2: 8000., 3: 8800., 4: 3500., 5: 2300., 6: 2300.,
               7: 12500., 8: 2800.}


def synth_alignment(seed: int, n_species: int, n_sites: int,
                    mut_prob: float = 0.15) -> np.ndarray:
    """Synthetic DNA alignment evolved along a random binary tree, drawn
    from ``RandomState(seed)`` as the JAX package draws it."""
    rng = np.random.RandomState(seed)
    seqs = {0: rng.randint(0, 4, size=n_sites)}
    nxt = 1
    leaves = [0]
    while len(leaves) < n_species:
        parent = leaves.pop(rng.randint(len(leaves)))
        for _ in range(2):
            child = seqs[parent].copy()
            mut = rng.rand(n_sites) < mut_prob
            child[mut] = rng.randint(0, 4, size=int(mut.sum()))
            seqs[nxt] = child
            leaves.append(nxt)
            nxt += 1
    out = np.stack([seqs[i] for i in leaves[:n_species]])
    return out.astype(np.int32)


def make_pair_table(num_slots: int) -> Tuple[np.ndarray, np.ndarray]:
    """pairs: (P, 2) slot pairs i < j; pair_index: (slots, slots) ->
    action, -1 on the diagonal."""
    pairs = [(i, j) for i in range(num_slots)
             for j in range(i + 1, num_slots)]
    pair_index = np.full((num_slots, num_slots), -1, np.int32)
    for a, (i, j) in enumerate(pairs):
        pair_index[i, j] = pair_index[j, i] = a
    return np.asarray(pairs, np.int32), pair_index


def _fitch_counts(fitch: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(..., S) uint8 Fitch sets -> (..., 15) int32: the sites holding each
    of ``values`` (1..15)."""
    return (fitch[..., None] == values).sum(-2, dtype=torch.int32)


#: the reward's temperature, the paper's for every dataset (§B.3)
ALPHA = 4.0


class ParsimonyRewardModule:
    """Rescaled Gibbs parsimony reward (paper §B.3):
    log R(x) = (C - M(x)) / alpha over mutation counts M, alpha = ALPHA."""

    def __init__(self, reward_c: float):
        self.reward_c = reward_c

    def init(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        return {"alpha": torch.tensor(ALPHA, **f32),
                "C": torch.tensor(self.reward_c, **f32)}

    def log_reward(self, score: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return (params["C"] - score) / params["alpha"]


@dataclasses.dataclass(frozen=True)
class PhyloState:
    node_fitch: torch.Tensor     # (B, 2n-1, S) uint8 in 1..15, 0 = empty
    node_children: torch.Tensor  # (B, 2n-1, 2) int32, -1 for leaves/empty
    node_mut: torch.Tensor       # (B, 2n-1) int32 mutations at the node
    root_mask: torch.Tensor      # (B, 2n-1) bool
    node_hist: torch.Tensor      # (B, 2n-1, 15) int32 sites per Fitch value
    score: torch.Tensor          # (B,) float32 parsimony M(s)
    merges: torch.Tensor         # (B,) int32
    steps: torch.Tensor          # (B,) int32


@dataclasses.dataclass(frozen=True)
class PhyloParams:
    """The leaves' Fitch sets, the reward's ``alpha`` and ``C``, and the
    constants the steps read on the device."""
    leaf_fitch: torch.Tensor     # (n, S) uint8 one-hot bitmask
    leaf_hist: torch.Tensor      # (n, 15) int32: the leaves' node_hist
    reward_params: Dict[str, torch.Tensor]
    pairs: torch.Tensor          # (P, 2) int64
    pair_index: torch.Tensor     # (2n-1, 2n-1) int64
    internal: torch.Tensor       # (2n-1,) bool
    values: torch.Tensor         # (15,) uint8: 1..15
    merges_total: torch.Tensor   # 0-dim float32: n - 1
    num_sites: torch.Tensor      # 0-dim float32: S

    @property
    def device(self) -> torch.device:
        return self.leaf_fitch.device


class PhyloEnvironment(Environment):

    def __init__(self, n_species: int, n_sites: int, reward_c: float,
                 seed: int = 0):
        self.n = n_species
        self.sites = n_sites
        self.reward_c = reward_c
        self.seed = seed
        self.reward_module = ParsimonyRewardModule(reward_c)
        self.num_slots = 2 * n_species - 1
        self.pairs, self.pair_index = make_pair_table(self.num_slots)
        self.action_dim = self.pairs.shape[0]
        self.backward_action_dim = self.num_slots
        self.max_steps = n_species - 1
        self.obs_feat_dim = 19

    @classmethod
    def from_dataset(cls, ds: int, seed: int = 0) -> "PhyloEnvironment":
        """DS``ds``'s species, sites and reward constant; the alignment
        drawn from ``seed + 100 * ds``."""
        ns, st = DS_DIMS[ds]
        return cls(ns, st, reward_c=DS_REWARD_C[ds], seed=seed + 100 * ds)

    def init(self, device: DeviceLike = None) -> PhyloParams:
        dev = resolve_device(device)
        aln = synth_alignment(self.seed, self.n, self.sites)
        f32 = dict(dtype=torch.float32, device=dev)
        leaf_fitch = torch.as_tensor((1 << aln).astype(np.uint8), device=dev)
        values = torch.arange(1, 16, dtype=torch.uint8, device=dev)
        return PhyloParams(
            leaf_fitch=leaf_fitch,
            leaf_hist=_fitch_counts(leaf_fitch, values),
            reward_params=self.reward_module.init(dev),
            pairs=torch.as_tensor(self.pairs, dtype=torch.int64, device=dev),
            pair_index=torch.as_tensor(self.pair_index, dtype=torch.int64,
                                       device=dev),
            internal=torch.arange(self.num_slots, device=dev) >= self.n,
            values=values,
            merges_total=torch.tensor(float(self.n - 1), **f32),
            num_sites=torch.tensor(float(self.sites), **f32))

    def reset(self, num_envs: int, params: PhyloParams
              ) -> Tuple[torch.Tensor, PhyloState]:
        B, K, S, n = num_envs, self.num_slots, self.sites, self.n
        dev = params.device
        i32 = dict(dtype=torch.int32, device=dev)
        state = PhyloState(
            node_fitch=torch.cat([
                params.leaf_fitch.expand(B, n, S),
                torch.zeros((B, K - n, S), dtype=torch.uint8, device=dev)],
                dim=1),
            node_children=torch.full((B, K, 2), -1, **i32),
            node_mut=torch.zeros((B, K), **i32),
            root_mask=(~params.internal).expand(B, K).clone(),
            node_hist=torch.cat([
                params.leaf_hist.expand(B, n, 15),
                torch.zeros((B, K - n, 15), **i32)], dim=1),
            score=torch.zeros((B,), dtype=torch.float32, device=dev),
            merges=torch.zeros((B,), **i32),
            steps=torch.zeros((B,), **i32))
        return self.observe(state, params), state

    def _first_empty_internal(self, state: PhyloState,
                              params: PhyloParams) -> torch.Tensor:
        """(B,) int64: the first internal slot that is empty (no children,
        not a root); ``argmax`` takes the first maximum, as JAX's."""
        empty = (state.node_children[..., 0] < 0) & ~state.root_mask \
            & params.internal
        return torch.argmax(empty.to(torch.int32), dim=-1)

    def _slot(self, k: torch.Tensor) -> torch.Tensor:
        """(B, 2n-1) bool one-hot of slot ``k`` (B,)."""
        return torch.arange(self.num_slots, device=k.device) == k[:, None]

    # -- dynamics ----------------------------------------------------------
    def _forward(self, state: PhyloState, action: torch.Tensor,
                 params: PhyloParams) -> PhyloState:
        S = self.sites
        ij = params.pairs[action.long()]                    # (B, 2)
        i, j = ij[:, 0], ij[:, 1]
        new = self._first_empty_internal(state, params)
        nf = state.node_fitch
        fi = torch.gather(nf, 1, i[:, None, None].expand(-1, 1, S))[:, 0]
        fj = torch.gather(nf, 1, j[:, None, None].expand(-1, 1, S))[:, 0]
        inter = torch.bitwise_and(fi, fj)
        has = inter != 0
        newf = torch.where(has, inter, torch.bitwise_or(fi, fj))
        mut = (~has).sum(-1, dtype=torch.int32)
        at_new = self._slot(new)
        return PhyloState(
            node_fitch=torch.where(at_new[:, :, None], newf[:, None, :], nf),
            node_children=torch.where(at_new[:, :, None],
                                      ij.to(torch.int32)[:, None, :],
                                      state.node_children),
            node_mut=torch.where(at_new, mut[:, None], state.node_mut),
            root_mask=(state.root_mask & ~self._slot(i) & ~self._slot(j))
            | at_new,
            node_hist=torch.where(at_new[:, :, None],
                                  _fitch_counts(newf, params.values)[:, None],
                                  state.node_hist),
            score=state.score + mut.to(torch.float32),
            merges=state.merges + 1, steps=state.steps + 1)

    def _backward(self, state: PhyloState, action: torch.Tensor,
                  params: PhyloParams) -> PhyloState:
        k = action.long()
        at_k = self._slot(k)
        ch = torch.gather(state.node_children, 1,
                          k[:, None, None].expand(-1, 1, 2))[:, 0].long()
        mut = torch.gather(state.node_mut, 1, k[:, None])[:, 0]
        # a leaf or an empty slot has children -1 (rows the mask leaves
        # with no legal split; backward_step discards them): slot 0
        i, j = ch[:, 0].clamp(min=0), ch[:, 1].clamp(min=0)
        return PhyloState(
            node_fitch=torch.where(at_k[:, :, None], 0, state.node_fitch),
            node_children=torch.where(at_k[:, :, None], -1,
                                      state.node_children),
            node_mut=torch.where(at_k, 0, state.node_mut),
            root_mask=(state.root_mask & ~at_k) | self._slot(i)
            | self._slot(j),
            node_hist=torch.where(at_k[:, :, None], 0, state.node_hist),
            score=state.score - mut.to(torch.float32),
            merges=torch.clamp(state.merges - 1, min=0),
            steps=torch.clamp(state.steps - 1, min=0))

    def is_terminal(self, state: PhyloState, params) -> torch.Tensor:
        return state.merges >= self.n - 1

    def is_initial(self, state: PhyloState, params) -> torch.Tensor:
        return state.merges == 0

    def log_reward(self, state: PhyloState,
                   params: PhyloParams) -> torch.Tensor:
        return self.reward_module.log_reward(state.score,
                                             params.reward_params)

    def energy(self, state: PhyloState, params: PhyloParams) -> torch.Tensor:
        """FLDB shaping: E(s0) = 0, E(x) = -log R(x)."""
        rp = params.reward_params
        frac = state.merges.to(torch.float32) / params.merges_total
        return (state.score - rp["C"] * frac) / rp["alpha"]

    def observe(self, state: PhyloState, params: PhyloParams
                ) -> torch.Tensor:
        """Slot-permutation-equivariant features (B, 2n-1, 19): the share of
        sites holding each of the 15 non-empty Fitch values, the root
        flag, the leaf flag, merges / (n-1), and node mutations / S."""
        B, K, _ = state.node_hist.shape
        hist = state.node_hist.to(torch.float32) / params.num_sites
        frac = state.merges.to(torch.float32) / params.merges_total
        return torch.cat([
            hist,
            state.root_mask[..., None].to(torch.float32),
            (~params.internal).to(torch.float32)[None, :, None].expand(
                B, K, 1),
            frac[:, None, None].expand(B, K, 1),
            (state.node_mut.to(torch.float32) / params.num_sites)[..., None],
        ], dim=-1)

    # -- masks ---------------------------------------------------------------
    def forward_mask(self, state: PhyloState, params: PhyloParams
                     ) -> torch.Tensor:
        r = state.root_mask
        return r[:, params.pairs[:, 0]] & r[:, params.pairs[:, 1]]

    def backward_mask(self, state: PhyloState, params: PhyloParams
                      ) -> torch.Tensor:
        return state.root_mask & params.internal

    def get_backward_action(self, state, action, next_state, params):
        """The reverse of "merge (i, j)" is "split the node just made"."""
        return self._first_empty_internal(state, params)

    def get_forward_action(self, state, bwd_action, prev_state, params):
        """The pair whose merge made the split node.  A row with no split
        to undo (a leaf's children, -1) reads the diagonal, -1, which is
        clamped to action 0 so that a gather over it stays in range (the
        rollouts mask such rows out)."""
        ch = torch.gather(state.node_children, 1,
                          bwd_action.long()[:, None, None].expand(-1, 1, 2)
                          )[:, 0].long().clamp(min=0)
        return params.pair_index[ch[:, 0], ch[:, 1]].clamp(min=0)
