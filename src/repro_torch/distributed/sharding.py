"""Which rows a shard owns (the plans' part of
``repro.distributed.sharding``: ``rollout_batch_specs`` and
``lane_state_specs``).

JAX states a layout as ``PartitionSpec`` trees that ``shard_map`` reads.
The port's shards are processes (training) or slices of one lane pool
(serving), so a layout is the rows each shard owns: shard ``r`` of ``D``
holds the ``r``-th contiguous block of the batch or lane axis.  A training
shard draws its block of a rollout batch itself (``ShardInfo.split_batch``
and ``env_offset`` in :mod:`repro_torch.algo.plan` give its size and
first global row); the serving pool cuts its lanes with
:func:`shard_rows`.  The LM's ``param_specs`` and
``input_sharding_specs`` are not ported here.
"""
from __future__ import annotations


def shard_rows(rank: int, num_shards: int, rows: int) -> slice:
    """The rows shard ``rank`` of ``num_shards`` owns of an axis of
    ``rows`` (a multiple of ``num_shards``): the ``rank``-th of equal
    contiguous blocks."""
    if rows % num_shards:
        raise ValueError(f"{rows} rows do not split over {num_shards} "
                         "shards")
    n = rows // num_shards
    return slice(rank * n, (rank + 1) * n)
