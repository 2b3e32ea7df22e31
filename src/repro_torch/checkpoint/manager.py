"""Checkpoint manager (port of ``repro.checkpoint.manager``, one process).

The on-disk format is the JAX package's, so checkpoints move between the
two packages:

- ``step_<N>/shards.proc0.npz``: one array per leaf, keyed by the leaf's
  flattened name with ``/`` written ``__``;
- ``step_<N>/MANIFEST.json``: ``{"step": N, "arrays": {name: {"shape",
  "dtype"}}}``, written last: a step directory without it is incomplete;
- bfloat16 leaves are stored as their ``uint16`` bits, with ``bfloat16``
  as the manifest's dtype.

A save writes ``step_<N>.tmp/`` and renames it to publish, so a crash
mid-save never leaves a partial checkpoint; the newest :data:`KEEP` steps
are kept.  ``save(..., blocking=False)`` copies every tensor to the host first
and hands only the file writes to a thread.

Trees are flat here: a mapping of flattened names (JAX's ``_flatten``:
dataclass fields with a leading dot, ``.train/.params/log_z``) to
tensors.  :mod:`repro_torch.algo.loop` names a training state's leaves;
:func:`lm_train_leaves` names an LM training state's, as
``repro.launch.train`` saves its ``(params, opt_state)``: ``0/log_z``,
``0/model/...``, ``1/1/.count``, ``1/1/.mu/...``.  A checkpoint written by
either package's ``launch.train`` resumes in the other.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..optim.adamw import state_leaves

#: flattened-name prefix of the policy params inside a training checkpoint
#: (JAX's ``LoopState.train.params``)
POLICY_PARAMS_PREFIX = ".train/.params"
#: complete steps a directory keeps (JAX's ``keep=3``)
KEEP = 3


def lm_train_leaves(params, opt_state) -> Dict[str, torch.Tensor]:
    """An LM training state ``(params, opt_state)`` (``{"model": ParamTree,
    "log_z"}`` and the optimizer chain's tuple) by JAX's flattened names:
    the params under ``0/``, the optimizer state under ``1/``.  The tensors
    are the state's own: :meth:`CheckpointManager.restore` copies into
    them in place."""
    return {**state_leaves(params, "0"), **state_leaves(opt_state, "1")}


def to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """``(array to store, logical dtype)`` of a tensor, copied to the
    host: bfloat16 as its uint16 bits."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return np.array(arr, copy=True), str(arr.dtype)


def to_tensor(arr: np.ndarray, logical: Optional[str]) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype (a bfloat16
    leaf's uint16 bits as torch.bfloat16)."""
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, directory: Union[str, Path]):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Mapping[str, torch.Tensor],
             blocking: bool = True) -> Path:
        """Write ``tree`` (flattened name -> tensor) as step
        ``step``.  Every leaf is copied to the host before this returns,
        so the caller may overwrite its tensors at once."""
        host: Dict[str, np.ndarray] = {}
        meta = {"step": int(step), "arrays": {}}
        for name, leaf in tree.items():
            arr, logical = to_host(leaf)
            host[name.replace("/", "__")] = arr
            meta["arrays"][name] = {"shape": list(arr.shape),
                                    "dtype": logical}

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "shards.proc0.npz", **host)
            (tmp / "MANIFEST.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)          # atomic publish
            self._gc()

        self.wait()     # never let two write()/_gc() bodies race
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return self.dir / f"step_{step}"

    def wait(self) -> None:
        """Block until an asynchronous save has been published."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-KEEP]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- discover ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """The complete steps (a ``MANIFEST.json``, no ``.tmp``), sorted."""
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "MANIFEST.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def newer_than(self, step: Optional[int]) -> Optional[int]:
        """The newest complete step after ``step`` (any complete step when
        ``step`` is None), else None."""
        latest = self.latest_step()
        if latest is None:
            return None
        if step is None or latest > int(step):
            return latest
        return None

    # -- restore --------------------------------------------------------------
    def load(self, step: int, prefix: str = ""
             ) -> Dict[str, torch.Tensor]:
        """Every stored leaf of ``step`` whose flattened name starts with
        ``prefix``, by name, as CPU tensors of the manifest's dtypes (only
        those leaves are read from the files)."""
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "MANIFEST.json").read_text())
        data: Dict[str, torch.Tensor] = {}
        for f in sorted(d.glob("shards.proc*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    name = k.replace("__", "/")
                    if not name.startswith(prefix):
                        continue
                    data[name] = to_tensor(
                        z[k], meta["arrays"].get(name, {}).get("dtype"))
        return data

    def restore(self, step: int, target: Mapping[str, torch.Tensor]
                ) -> Mapping[str, torch.Tensor]:
        """Copy step ``step``'s leaves into ``target``'s tensors (flattened
        name -> tensor), in place and cast to each tensor's dtype; a name
        the checkpoint lacks or a shape that differs raises."""
        data = self.load(step)
        for name in target:
            if name not in data:
                raise ValueError(
                    f"checkpoint step_{step} in {self.dir} has no entry for "
                    f"{name!r}: it was saved from a different configuration "
                    "(e.g. a different sampler, or without an eval suite); "
                    "restore with the configuration it was saved under")
        copy_into(target, {n: data[n] for n in target}, f"step_{step}")
        return target

    def restore_latest(self, target: Mapping[str, torch.Tensor]
                       ) -> Tuple[Optional[int], Mapping[str, torch.Tensor]]:
        step = self.latest_step()
        if step is None:
            return None, target
        return step, self.restore(step, target)

    def restore_subtree(self, step: int, target: Mapping[str, torch.Tensor],
                        prefix: str = POLICY_PARAMS_PREFIX
                        ) -> Mapping[str, torch.Tensor]:
        """Copy only the leaves under ``prefix`` into ``target`` (leaf
        name -> tensor, read as ``{prefix}/{name}``): the serving loader,
        which needs the policy params of a training checkpoint and nothing
        of its optimizer, sampler or metrics state."""
        data = self.load(step, prefix)
        got = {}
        for name in target:
            full = f"{prefix}/{name}" if name else prefix
            if full not in data:
                have = sorted(k for k in data if k.startswith(prefix))
                raise ValueError(
                    f"checkpoint step_{step} in {self.dir} has no entry for "
                    f"{full!r}; the policy it was trained with does not "
                    f"match this one (saved under {prefix!r}: {have})")
            got[name] = data[full]
        copy_into(target, got, f"step_{step}")
        return target


def copy_into(target: Mapping[str, torch.Tensor],
              arrays: Mapping[str, torch.Tensor], where: str) -> None:
    """``target[name].copy_(arrays[name])`` for every name, after checking
    every shape; the tensors keep their storage, so a CUDA graph that
    holds them reads the restored values."""
    for name, t in target.items():
        if tuple(arrays[name].shape) != tuple(t.shape):
            part = name.lstrip(".").split("/")[0]
            raise ValueError(
                f"{where}: checkpointed {part} state does not match this "
                f"run's shapes (first mismatch: {name!r} restored "
                f"{tuple(arrays[name].shape)} vs expected {tuple(t.shape)}"
                "); resume with the same plan, num_envs, and sampler "
                "configuration the checkpoint was saved under (and the "
                "same policy)")
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(arrays[name].to(t.dtype))
