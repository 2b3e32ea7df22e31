"""LM training driver (port of ``repro.launch.train``): GFlowNet-TB
fine-tuning (or CE pretraining) of any registered architecture on one
device, with checkpointing and auto-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 4 --ckpt-dir ckpt            # full width, on cuda

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  ``--mesh`` takes ``1x1`` only: JAX's other
meshes shard the model and the optimizer state, which waits for
``ROADMAP.md``'s queue 1 item 21.  What the JAX driver does, this one does:

  - the model's weights are drawn from ``--seed`` (a ``torch.Generator`` on
    the device, so not JAX's values), log Z warm-started from a pilot batch
    (``log Z ~= E[log R - log P_F]``);
  - every step's batch is ``data.tokens.synthetic_gfn_batch(seed, step)``,
    bitwise JAX's;
  - a checkpoint every ``ckpt_every`` steps (written by a thread; the host
    copy is taken first) and one at the end, under JAX's flattened names
    (``checkpoint.manager.lm_train_leaves``), so a run of either package
    resumes in the other;
  - auto-resume from the newest complete step.  As in JAX, a mid-run save
    labelled ``s`` holds the state after step ``s`` ran, and a resume from
    it runs step ``s`` again; the final save is labelled ``steps``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager, lm_train_leaves
from ..configs.registry import ARCH_IDS, get_config
from ..data.tokens import synthetic_gfn_batch
from ..device import DeviceLike, resolve_device
from ..models import lm as LM
from ..models.config import ModelConfig
from . import steps as steps_mod


def _mesh_refused(mesh_shape: Tuple[int, ...]) -> None:
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {'x'.join(map(str, mesh_shape))}: the port trains on one "
            "device (mesh 1x1); sharded meshes wait for ROADMAP.md queue 1 "
            "item 21 (the dry run and sharding)")


@torch.no_grad()
def pilot_log_z(params, cfg: ModelConfig, batch: int, seq: int, *,
                seed: int, device) -> torch.Tensor:
    """JAX's warm start: ``mean(log R - sum_t mask log p_theta)`` over the
    step-0 batch, a 0-dim float32 tensor."""
    pilot = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=0,
                                device=device)
    lp, _ = LM.forward_train(params["model"], cfg, pilot)
    log_pf = torch.sum(lp.to(torch.float32) * pilot["mask"], -1)
    return torch.mean(pilot["log_reward"] - log_pf)


def init_state(cfg: ModelConfig, tcfg: steps_mod.LMTrainConfig, *,
               seed: int, device) -> Tuple[Dict[str, Any], Any, Callable]:
    """``(params, opt_state, train_step)`` of a fresh run: the model drawn
    from a generator seeded with ``seed`` on ``device``, log Z at 0, the
    optimizer chain's initial state."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    params = steps_mod.init_lm_params(cfg, generator=gen, device=device)
    train_step, tx = steps_mod.make_train_step(cfg, tcfg)
    opt_state = tx.init(
        {n: t.detach() for n, t in steps_mod.param_leaves(params).items()})
    return params, opt_state, train_step


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               mesh_shape=(1, 1), ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, seed: int = 0,
               objective: str = "tb", lr: float = 3e-4,
               log_every: int = 10, callback=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps (JAX's ``train_loop``, on one
    device).  Returns ``{"params", "opt_state", "history"}``; the history
    holds ``{"step", "loss"}`` at every ``log_every``-th step and the last
    (the loss read to the host only there).  ``callback(step, params,
    metrics)`` runs at those steps."""
    _mesh_refused(tuple(mesh_shape))
    dev = resolve_device(device)
    tcfg = steps_mod.LMTrainConfig(objective=objective, lr=lr)
    params, opt_state, train_step = init_state(cfg, tcfg, seed=seed,
                                               device=dev)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if objective == "tb":
        with torch.no_grad():
            params["log_z"].copy_(pilot_log_z(params, cfg, batch, seq,
                                              seed=seed, device=dev))
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        mgr.restore(start, lm_train_leaves(params, opt_state))
        print(f"[resume] restored step {start} from {ckpt_dir}")

    history = []
    t0 = time.time()
    for step in range(start, steps):
        b = synthetic_gfn_batch(cfg, batch, seq, seed=seed, step=step,
                                device=dev)
        params, opt_state, metrics = train_step(params, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss})
            print(f"step {step:5d} loss {loss:10.4f} "
                  f"({(time.time() - t0):6.1f}s)", flush=True)
            if callback:
                callback(step, params, metrics)
        if mgr is not None and step > start and step % ckpt_every == 0:
            mgr.save(step, lm_train_leaves(params, opt_state),
                     blocking=False)
    if mgr is not None:
        mgr.save(steps, lm_train_leaves(params, opt_state), blocking=True)
    return {"params": params, "opt_state": opt_state, "history": history}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH_IDS[0], choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only (sharded meshes: ROADMAP.md item 21)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--objective", default="tb", choices=["tb", "ce"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    _mesh_refused(mesh_shape)
    cfg = get_config(args.arch, smoke=args.smoke)
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               mesh_shape=mesh_shape, ckpt_dir=args.ckpt_dir,
               objective=args.objective, lr=args.lr, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
