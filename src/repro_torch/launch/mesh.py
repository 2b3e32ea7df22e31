"""Process groups for the port's execution plans (the part of
``repro.launch.mesh`` the plans use: ``make_mesh((D,), ("batch",))``).

JAX's data-parallel plan builds a one-axis device mesh in one process.
The port's is a ``torch.distributed`` group of D processes, one a shard,
each driving its own device: :func:`init_group` starts this process's
membership.  A group of one is a real group (its all-reduce runs), not a
bypass, so ``data_parallel(1)`` exercises the collective path.

The rendezvous is a :class:`torch.distributed.FileStore` on a file in a
temporary directory, so no TCP port is opened and concurrent runs (test
workers) never meet; the ranks of one group must be given the same file.
The backend is NCCL when the rank's device is CUDA and gloo on the CPU.
NCCL's all-reduce can be captured in a CUDA graph; gloo's cannot, so a
gloo group trains eagerly, on the CPU only.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist


def backend_for(device: Union[str, torch.device]) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def store_file(directory: Optional[Union[str, Path]] = None) -> str:
    """A fresh rendezvous file path (the file itself does not exist yet) in
    ``directory``, default a new temporary directory."""
    d = Path(directory) if directory is not None else Path(
        tempfile.mkdtemp(prefix="repro_torch_group_"))
    return str(d / "store")


def under_launcher() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank:
    ``RANK`` and ``WORLD_SIZE`` are set."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_group(world_size: int, rank: int,
               device: Union[str, torch.device], *,
               store_path: Optional[str] = None) -> bool:
    """Join (or start) the default process group as ``rank`` of
    ``world_size`` for a rank driving ``device``.  Under ``torchrun`` the
    launcher's environment names the group; otherwise the ranks meet on
    the :class:`~torch.distributed.FileStore` at ``store_path`` (a fresh
    one of this process's own when None, which only a group of one can
    use).  Returns True when this call made the group (the caller then
    ends it with :func:`destroy_group`), False when a group of the same
    size and rank already existed.  A group of another size or rank
    raises."""
    world_size, rank = int(world_size), int(rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a group of {world_size}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(
                f"a process group of {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) is already running; this plan needs "
                f"rank {rank} of {world_size}")
        return False
    backend = backend_for(device)
    if backend == "nccl":
        # the all-reduce is captured inside the training iteration's CUDA
        # graph (torch.cuda.graphs's note on NCCL collectives)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(torch.device(device))
    if store_path is None and under_launcher():
        dist.init_process_group(backend, init_method="env://",
                                world_size=world_size, rank=rank)
        return True
    if store_path is None:
        if world_size != 1:
            raise ValueError(
                f"a group of {world_size} ranks needs every rank started "
                "with the same store_path (repro_torch.launch.mesh.store_file"
                "; python -m repro_torch.run starts its ranks so) or under "
                "torchrun")
        store_path = store_file()
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank)
    return True


def destroy_group() -> None:
    """End this process's default group (nothing when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()
