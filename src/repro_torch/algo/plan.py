"""Execution plans: where, and how many times, a training step runs (port
of ``repro.algo.plan``).

    single                 one device (default)
    vmap_seeds(S)          S independent training runs on one device: the
                           iteration under ``torch.func.vmap`` over a
                           leading seed axis of the stacked parameters
    data_parallel(D)       rollouts and objectives sharded over D ranks of
                           a ``torch.distributed`` group along the batch
                           axis (:mod:`repro_torch.launch.mesh`)
    seeds_x_data(S, D)     their composition: vmap inside the shard

What a plan decides, as in JAX:

- **the group.** JAX's mesh is a ``(D,)`` device mesh in one process; the
  port's is a process group of D ranks, one a shard, each on its own
  device (rank r on ``cuda:r``, or every rank on the CPU over gloo).  A
  rank joins it with :meth:`DataParallelPlan.join`.
- **noise.** Every rollout draw is keyed per *global* env id
  (:meth:`ShardInfo.env_offset`), so a ``data_parallel`` run samples the
  trajectories of a ``single`` run of the same global batch.  Draws that
  must differ per shard (replay selection, the replay's backward rollout)
  go through :meth:`ShardInfo.fold_shard`.  Seed ``s`` of a seed plan
  seeded ``seed`` is the single run seeded :func:`seed_of` ``(seed, s)``:
  its policy is drawn from that seed and iteration i draws from
  ``train_seed(seed_of(seed, s), i)``.
- **state.** The sampler's state (a replay buffer) lives per shard, in
  each rank; parameters and the optimizer are replicated; the objective's
  ``(num, den)`` parts and the gradients are summed over the group
  (:meth:`ShardInfo.psum`, one all-reduce an iteration) before the single
  division and the Adam step, so every rank applies the same update.

The serving engine shards its lane pool over a ``data_parallel`` plan's
:meth:`DataParallelPlan.serve_devices` in one process, as JAX's does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

#: the odd 32-bit constant that spreads a shard index over a seed's high
#: half (:meth:`ShardInfo.fold_shard`)
_FOLD = 0x9E3779B9


def seed_of(seed: int, s: int) -> int:
    """The seed of seed ``s`` of a seed plan's run seeded ``seed``:
    ``seed + s``.  A single run given that seed draws the same policy and
    the same noise, iteration for iteration."""
    seed, s = int(seed), int(s)
    if s < 0 or not 0 <= seed + s < 2 ** 31:
        raise ValueError(f"seed_of: seed {seed} + {s} out of range")
    return seed + s


def _visible_devices() -> int:
    """JAX's ``jax.device_count()`` for the port: the running group's size,
    else the visible cards (at least 1)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


class ShardInfo:
    """How one training step sees the plan from inside the step.

    ``split_batch`` turns a global batch into this shard's rows,
    ``env_offset`` is the global index of the shard's first env (``rank *
    local_batch``, 0 off a sharded plan), ``fold_shard`` gives a noise seed
    this shard's own stream, and ``psum`` sums over the group."""

    def __init__(self, axis: Optional[str] = None, num_shards: int = 1,
                 rank: int = 0):
        self.axis = axis
        self.num_shards = int(num_shards)
        self.rank = int(rank)

    def split_batch(self, global_batch: int) -> int:
        if self.num_shards == 1:
            return global_batch
        if global_batch % self.num_shards:
            raise ValueError(
                f"global batch {global_batch} is not divisible by the "
                f"{self.num_shards}-shard mesh axis {self.axis!r}; pick a "
                "batch size that is a multiple of the device count")
        return global_batch // self.num_shards

    def env_offset(self, local_batch: int) -> int:
        if self.axis is None:
            return 0
        return self.rank * int(local_batch)

    def fold_shard(self, seed: torch.Tensor) -> torch.Tensor:
        """A noise seed decorrelated across shards (replay selection, the
        replay's backward rollout): the seed's high half XOR a constant of
        the rank, so its low half (the iteration) stays readable.  The
        identity on one shard, so ``data_parallel(1)`` is bitwise
        ``single`` (JAX folds the index in even then)."""
        if self.num_shards == 1:
            return seed
        c = (((self.rank + 1) * _FOLD) & 0x7FFFFFFF) << 32
        return seed ^ c

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place (one all-reduce)."""
        if self.axis is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t


class ExecutionPlan:
    """The single-device plan: the identity layout (and the base class).

    ``shard_info()`` how samplers slice the batch; ``seeds`` the seed
    axis's size (None: no seed axis); ``describe()`` the plan's fields for
    logs and perf rows (JAX's keys)."""

    name = "single"
    seeds: Optional[int] = None

    def shard_info(self) -> ShardInfo:
        return ShardInfo()

    @property
    def device_count(self) -> int:
        return 1

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def mesh_shape(self) -> Optional[Tuple[int, ...]]:
        return None

    def join(self, device: Union[str, torch.device]) -> None:
        """Take part in the plan from a rank on ``device`` (nothing to
        join off a sharded plan)."""

    def close(self) -> None:
        """End what :meth:`join` started."""

    def describe(self) -> dict:
        return {"plan": self.name, "device_count": self.device_count,
                "mesh_shape": (list(self.mesh_shape)
                               if self.mesh_shape else None)}

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}"
                         for k, v in dict(self.describe(),
                                          num_seeds=self.seeds).items()
                         if k != "plan" and v not in (None, 1))
        return f"{type(self).__name__}({args})"


class VmapSeedsPlan(ExecutionPlan):
    """S independent training runs on one device: the iteration runs under
    ``torch.func.vmap`` over a leading seed axis of the stacked parameters,
    so each kernel call site launches once for all S seeds."""

    name = "vmap_seeds"

    def __init__(self, num_seeds: int):
        if not num_seeds or num_seeds < 1:
            raise ValueError(f"vmap_seeds needs num_seeds >= 1, "
                             f"got {num_seeds!r}")
        self.seeds = int(num_seeds)


class DataParallelPlan(ExecutionPlan):
    """The batch axis sharded over D ranks of a ``torch.distributed``
    group (training), or a lane pool over D devices in one process
    (serving).

    ``num_devices`` is D (default: the running group's size, else the
    visible cards); ``devices`` names the serving shards' devices instead
    (a device may repeat: ``["cpu"] * 4``).  A training rank calls
    :meth:`join` with its device before its first step: it is rank
    ``dist.get_rank()`` of the running group (``torchrun``, the ranks
    ``python -m repro_torch.run`` starts, or any that called
    :func:`repro_torch.launch.mesh.init_group`), or with no group running
    the one rank of a group of one that :meth:`join` starts."""

    name = "data_parallel"

    def __init__(self, num_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None, axis: str = "batch"):
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("data_parallel needs at least one device")
            if num_devices is not None and num_devices != len(devices):
                raise ValueError(f"num_devices {num_devices} and "
                                 f"{len(devices)} devices disagree")
        elif num_devices is not None and int(num_devices) < 1:
            raise ValueError(f"data_parallel needs num_devices >= 1, got "
                             f"{num_devices!r}")
        self.axis = axis
        self._devices = devices
        self._num_devices = None if num_devices is None else int(num_devices)
        self._owns_group = False

    @property
    def num_shards(self) -> int:
        if self._devices is not None:
            return len(self._devices)
        if self._num_devices is None:
            self._num_devices = _visible_devices()
        return self._num_devices

    @property
    def device_count(self) -> int:
        return self.num_shards

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.num_shards,)

    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def shard_info(self) -> ShardInfo:
        return ShardInfo(axis=self.axis, num_shards=self.num_shards,
                         rank=self.rank)

    def join(self, device: Union[str, torch.device]) -> None:
        from ..launch.mesh import backend_for, init_group
        made = init_group(self.num_shards, self.rank, device)
        if dist.get_backend() != backend_for(device):
            raise ValueError(
                f"the running {dist.get_backend()} group cannot reduce "
                f"tensors on {device}")
        self._owns_group = self._owns_group or made

    def close(self) -> None:
        from ..launch.mesh import destroy_group
        if self._owns_group:
            destroy_group()
            self._owns_group = False

    def serve_devices(self) -> List[torch.device]:
        """The devices of a serving pool's shards: the ``devices`` given,
        else ``cuda:0 .. cuda:D-1``, which must exist."""
        if self._devices is not None:
            return list(self._devices)
        n = self.num_shards
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"a {n}-shard lane pool needs {n} CUDA devices, this "
                f"machine has {have}; pass the devices (a device may "
                "repeat, e.g. ['cuda:0'] * 2 or ['cpu'] * 4)")
        return [torch.device("cuda", i) for i in range(n)]


class SeedsByDataPlan(DataParallelPlan):
    """``seeds x data``: every rank holds its batch shard of all S seeds
    (the seed vmap inside the shard); the per-seed sums are reduced over
    the group together."""

    name = "seeds_x_data"

    def __init__(self, num_seeds: int, num_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None, axis: str = "batch"):
        super().__init__(num_devices=num_devices, devices=devices,
                         axis=axis)
        if not num_seeds or num_seeds < 1:
            raise ValueError(f"seeds_x_data needs num_seeds >= 1, "
                             f"got {num_seeds!r}")
        self.seeds = int(num_seeds)


PLANS = {
    cls.name: cls for cls in (ExecutionPlan, VmapSeedsPlan,
                              DataParallelPlan, SeedsByDataPlan)
}


def _dp_kwargs(devices) -> dict:
    """``devices`` as a count or a list of serving devices."""
    if devices is None or isinstance(devices, int):
        return {"num_devices": devices}
    return {"devices": list(devices)}


def make_plan(spec=None, *, devices: Union[int, Sequence, None] = None,
              num_seeds: Optional[int] = None,
              num_envs: Optional[int] = None) -> ExecutionPlan:
    """A plan from a spec: an instance (returned as is) or a name,
    ``single`` | ``vmap_seeds`` | ``data_parallel`` | ``seeds_x_data`` |
    ``auto`` (data_parallel over every visible device when there is more
    than one, with :func:`auto_plan`'s fallback to single when
    ``num_envs`` does not divide).  ``devices`` is the shard count, or
    (``data_parallel``, ``seeds_x_data``) the serving shards' devices."""
    if spec is None:
        spec = "single"
    if isinstance(spec, ExecutionPlan):
        return spec
    if spec == "auto":
        if num_seeds is not None:
            raise ValueError(
                "plan 'auto' never adds a seed axis; pick 'vmap_seeds' or "
                "'seeds_x_data' explicitly when passing num_seeds")
        if num_envs is not None:
            return auto_plan(num_envs, devices)
        n = devices or _visible_devices()
        if n > 1:
            return DataParallelPlan(num_devices=n)
        return ExecutionPlan()
    if spec == "single":
        return ExecutionPlan()
    if spec == "vmap_seeds":
        return VmapSeedsPlan(num_seeds)
    if spec == "data_parallel":
        return DataParallelPlan(**_dp_kwargs(devices))
    if spec == "seeds_x_data":
        return SeedsByDataPlan(num_seeds, **_dp_kwargs(devices))
    raise KeyError(f"unknown plan {spec!r}; "
                   f"available: {sorted(PLANS)} + 'auto'")


def auto_plan(num_envs: int, devices: Optional[int] = None) -> ExecutionPlan:
    """``auto`` with JAX's divisibility guard: data_parallel over the
    visible devices when the global batch shards evenly, else single."""
    n = devices or _visible_devices()
    if n > 1 and num_envs % n == 0:
        return DataParallelPlan(num_devices=n)
    return ExecutionPlan()
