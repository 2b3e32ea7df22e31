"""Flat FIFO buffer over device tensors (port of ``repro.buffer.fifo``).

JAX's buffer threads a pure :class:`BufferState` through the compiled
step.  Here the state's tensors live on the device and every operation
updates them in place, with no host read: ``insert_pos`` and ``size``
are 0-dim int64 tensors, and the wrap-around and ``max(size, 1)`` are
computed on the device, so a training iteration captured in a CUDA graph
can add to the buffer and draw from it on every replay.

Draws take explicit noise operands instead of a key, as every draw of
the port does: ``sample`` a (R,) uniform per item (JAX's
``jax.random.randint``), ``sample_prioritized`` a (R, capacity) Gumbel row
per item (JAX's ``jax.random.categorical``, a Gumbel-max over the filled
slots).  :func:`repro_torch.core.types.hash_select_noise` is the default
source.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class BufferState:
    """``data``: name -> (capacity, ...) tensor; ``insert_pos`` and
    ``size``: 0-dim int64 tensors on the same device."""
    data: Dict[str, torch.Tensor]
    insert_pos: torch.Tensor
    size: torch.Tensor


class FIFOBuffer:
    """Fixed-capacity circular buffer over a dict of tensors.

    Like JAX's, the buffer is single-shard: :meth:`per_shard` gives one
    shard's slice of a global capacity, with JAX's arithmetic and errors.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    @classmethod
    def per_shard(cls, global_capacity: int, num_shards: int = 1,
                  min_batch: int = 0) -> "FIFOBuffer":
        """A shard's slice of a ``global_capacity`` buffer split over
        ``num_shards`` devices; ``min_batch`` (the shard's per-step insert
        size) guards against a split too small to absorb one batch."""
        if num_shards > 1 and global_capacity % num_shards:
            raise ValueError(
                f"replay capacity {global_capacity} is not divisible by "
                f"{num_shards} shards; pick a multiple of the device count")
        cap = global_capacity // max(num_shards, 1)
        if cap < min_batch:
            raise ValueError(
                f"per-shard replay capacity {cap} (= {global_capacity} / "
                f"{num_shards}) cannot absorb a per-shard batch of "
                f"{min_batch}; grow the buffer or shrink the batch")
        return cls(cap)

    def init(self, prototype: Dict[str, torch.Tensor]) -> BufferState:
        """An empty buffer of items shaped like ``prototype`` (name -> one
        item's tensor), zeros on the prototype's device."""
        dev = next(iter(prototype.values())).device
        data = {k: torch.zeros((self.capacity,) + tuple(x.shape),
                               dtype=x.dtype, device=dev)
                for k, x in prototype.items()}
        i64 = dict(dtype=torch.int64, device=dev)
        return BufferState(data=data, insert_pos=torch.zeros((), **i64),
                           size=torch.zeros((), **i64))

    def add_batch(self, state: BufferState,
                  items: Dict[str, torch.Tensor]) -> BufferState:
        """Write ``items`` (name -> (B, ...), B <= capacity) at the next B
        slots, wrapping around; in place.  Returns ``state``."""
        B = next(iter(items.values())).shape[0]
        if B > self.capacity:
            # duplicate scatter indices would leave unspecified winners
            raise ValueError(
                f"add_batch of {B} items exceeds buffer capacity "
                f"{self.capacity}; grow the buffer or shrink the batch")
        idx = (state.insert_pos + torch.arange(
            B, dtype=torch.int64, device=state.size.device)) % self.capacity
        for k, buf in state.data.items():
            buf.index_copy_(0, idx, items[k].to(buf.dtype))
        state.insert_pos.copy_((state.insert_pos + B) % self.capacity)
        state.size.copy_(torch.clamp(state.size + B, max=self.capacity))
        return state

    def _gather(self, state: BufferState,
                idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: buf.index_select(0, idx) for k, buf in state.data.items()}

    def sample(self, state: BufferState,
               uniform: torch.Tensor) -> Dict[str, torch.Tensor]:
        """R items drawn uniformly from the filled slots, one per entry of
        ``uniform`` (R,) in (0, 1): slot ``floor(u * max(size, 1))``."""
        n = torch.clamp(state.size, min=1)
        idx = torch.floor(uniform.to(torch.float32)
                          * n.to(torch.float32)).to(torch.int64)
        return self._gather(state, torch.minimum(idx, n - 1))

    def sample_prioritized(self, state: BufferState, gumbel: torch.Tensor,
                           priorities: torch.Tensor,
                           temperature: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """R items drawn from softmax(priorities / temperature) over the
        filled slots by Gumbel-max: ``gumbel`` (R, capacity); unfilled
        slots (past ``max(size, 1)``) are excluded.  ``priorities`` is a
        (capacity,) tensor aligned with the storage (reward-prioritized
        replay passes the stored log-rewards); ``temperature`` a 0-dim
        float32 tensor on their device (a true division: CUDA would
        multiply by a Python number's reciprocal)."""
        slots = torch.arange(self.capacity, device=state.size.device)
        filled = slots < torch.clamp(state.size, min=1)
        logits = torch.where(filled, priorities / temperature,
                             float("-inf"))
        idx = torch.argmax(logits[None, :] + gumbel, dim=-1)
        return self._gather(state, idx)

    def valid_mask(self, state: BufferState) -> torch.Tensor:
        """(capacity,) bool: the filled slots."""
        return torch.arange(self.capacity,
                            device=state.size.device) < state.size
