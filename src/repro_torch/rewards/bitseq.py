"""Bit-sequence reward: minimum-Hamming-distance modes (port of
``repro.rewards.bitseq``).

log R(x) = -beta * min_{x' in M} d(x, x') / n, with Hamming distance d and a
fixed mode set M of 60 strings, each the concatenation of n/8 patterns drawn
from H = {00000000, 11111111, 11110000, 00001111, 00111100}.  Distances are
computed per k-bit word by popcount over the (B, L) word sequence.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_H_PATTERNS = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 1, 1, 1],
    [0, 0, 1, 1, 1, 1, 0, 0],
], dtype=np.int32)


def make_mode_set(seed: int, n: int, num_modes: int = 60) -> np.ndarray:
    """Mode set M: per mode, n/8 patterns from H drawn with
    ``np.random.RandomState(seed)`` (the JAX package's exact draws)."""
    rng = np.random.RandomState(seed)
    chunks = n // 8
    modes = np.zeros((num_modes, n), np.int32)
    for i in range(num_modes):
        picks = rng.randint(0, len(_H_PATTERNS), size=chunks)
        modes[i] = _H_PATTERNS[picks].reshape(-1)
    return modes


def make_test_set(seed: int, modes: np.ndarray) -> np.ndarray:
    """The flip test set (paper §B.2): for every mode and every
    0 <= i < n, the mode with i random bits flipped, drawn with
    ``np.random.RandomState(seed + 1)`` (the JAX package's exact draws).
    Returns (|M| * n, n) int32 bits."""
    rng = np.random.RandomState(seed + 1)
    num_modes, n = modes.shape
    out = np.zeros((num_modes * n, n), np.int32)
    row = 0
    for mi in range(num_modes):
        for i in range(n):
            x = modes[mi].copy()
            flip = rng.choice(n, size=i, replace=False)
            x[flip] = 1 - x[flip]
            out[row] = x
            row += 1
    return out


def popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    c = torch.zeros_like(x)
    for i in range(bits):
        c = c + ((x >> i) & 1)
    return c


class BitSeqRewardModule:
    """log R(x) = -beta * min Hamming(x, M) / n over (B, L) word sequences
    of ``word_bits``-bit words."""

    def __init__(self, *, word_bits: int, length: int, beta: float = 3.0,
                 num_modes: int = 60, seed: int = 0):
        self.k = int(word_bits)
        self.n = self.k * int(length)
        if self.n % 8:
            raise ValueError("the mode set is built from 8-bit patterns: "
                             f"n = {self.n} must be a multiple of 8")
        self.beta = float(beta)
        self.num_modes = int(num_modes)
        self.seed = int(seed)

    def init(self, device: torch.device) -> Dict[str, torch.Tensor]:
        modes = make_mode_set(self.seed, self.n, self.num_modes)
        # word id per k-bit block, most significant bit first
        pw = 2 ** np.arange(self.k - 1, -1, -1)
        mode_words = (modes.reshape(self.num_modes, -1, self.k) * pw).sum(-1)
        return {"modes": torch.as_tensor(modes, device=device),
                "mode_words": torch.as_tensor(mode_words, dtype=torch.int32,
                                              device=device),
                "beta": torch.tensor(self.beta, dtype=torch.float32,
                                     device=device)}

    def log_reward(self, words: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
        xor = torch.bitwise_xor(words[:, None, :].to(torch.int32),
                                params["mode_words"][None])
        ham = popcount(xor, self.k).sum(-1)                 # (B, |M|)
        dmin = ham.min(dim=-1).values.to(torch.float32)
        return -params["beta"] * dmin / self.n
