"""Sampling primitives of the port (port of ``repro.core.types``).

Torch cannot reproduce JAX's threefry key stream, so sampling here takes an
explicit Gumbel operand ``(B, A)`` instead of a key: the categorical draw
``jax.random.categorical(k, logp)`` is ``argmax(logp + gumbel(k))``, and a
caller that feeds the same Gumbel noise gets the same actions.

Where the noise comes from is a *noise source*: a callable
``noise(seed, index, t, num_actions) -> (B, A) float32`` over (B,) int64
tensors naming, per row, the request seed, the sample index within the
request, and the trajectory step.  The default, :func:`hash_gumbel`, is a
counter-based hash of ``(seed, index, t, action)``; it is the port's
counterpart of JAX's ``fold_in(split(key, T)[t], index)``: a sample's noise
depends on nothing but those four numbers, so it is independent of lane
placement, co-tenants and lane count.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

NoiseSource = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                       torch.Tensor]

_MASK32 = 0xFFFFFFFF


def masked_logprobs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Log-softmax restricted to legal actions (mask True = legal).
    Illegal logits become ``finfo.min``, not ``-inf``, as in the JAX
    package."""
    neg = torch.tensor(torch.finfo(logits.dtype).min, dtype=logits.dtype,
                       device=logits.device)
    return torch.log_softmax(torch.where(mask, logits, neg), dim=-1)


def sample_masked(logits: torch.Tensor, mask: torch.Tensor,
                  gumbel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-max sample from the masked policy (the ``eps == 0`` branch of
    ``repro.core.types.sample_masked``).  Ties go to the lowest index, as in
    ``jnp.argmax``.  Returns ``(actions int64, log_prob_of_action)``."""
    logp = masked_logprobs(logits, mask)
    actions = torch.argmax(logp + gumbel, dim=-1)
    return actions, torch.gather(logp, -1, actions[..., None])[..., 0]


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix on int64 tensors holding values < 2**32.
    Multipliers stay below 2**31, so no product leaves int64 and every
    device computes the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _MASK32
    return x ^ (x >> 16)


def _row_key(seed: torch.Tensor, index: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """(B,) 32-bit key of (seed, index, t), each as int64."""
    seed = seed.long()
    h = _mix32(seed & _MASK32)
    h = _mix32(h ^ ((seed >> 32) & _MASK32) ^ 0x68E31DA4)
    h = _mix32(h ^ (index.long() & _MASK32) ^ 0x1B56C4E9)
    return _mix32(h ^ (t.long() & _MASK32) ^ 0x2C8F3A71)


def hash_gumbel(seed: torch.Tensor, index: torch.Tensor, t: torch.Tensor,
                num_actions: int) -> torch.Tensor:
    """Default noise source: standard Gumbel noise ``(B, num_actions)`` from
    a counter-based hash of ``(seed[b], index[b], t[b], a)``.

    The integer hash is plain int64 tensor arithmetic, so it gives the same
    bits on every device; the top 24 bits become a uniform in (0, 1), and
    ``-log(-log(u))`` the Gumbel variate.  Every step is elementwise, so a
    row's noise does not depend on the rows beside it."""
    a = torch.arange(num_actions, dtype=torch.int64, device=seed.device)
    h = _mix32(_row_key(seed, index, t)[:, None] ^ _mix32(a ^ 0x5BD1E995))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))
