"""The JAX package's LM training trajectory: the TB loss of
``examples/lm_gfn_finetune.py``'s 25M-parameter model (``model_25m``:
dense, 8 layers, d_model 320, 5/1 heads of 64, bf16, batch 4, seq 96, lr
1e-4), the reference that ``chip_smoke.py``'s ``lm_converge`` phase holds
the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_train_reference.py \\
        [--seeds 0 1 2] [--steps 300] [--at 0 100 200 299]

For each seed s it runs what ``repro.launch.train.train_loop`` runs on a
1x1 mesh -- ``init_lm_params(PRNGKey(s))``, log Z warm-started from the
step-0 pilot batch, then ``make_train_step`` jitted on
``synthetic_gfn_batch(seed=s, step=t)`` -- without the mesh's shardings:
under JAX 0.9 ``train_loop`` itself fails at the embedding gather with a
ShardingTypeError for this model (``ROADMAP.md``, queue 3).  It prints the
loss at each step of ``--at``, one JSON line a seed; then the mean and the
spread (largest minus smallest) over the seeds at each step.  About 1-2
minutes a seed on a CPU.  It runs the JAX package (the reference), not the
port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.data.tokens import synthetic_gfn_batch
from repro.launch import steps as steps_mod
from repro.models import lm as LM

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
from lm_gfn_finetune import model_25m  # noqa: E402

BATCH, SEQ, LR = 4, 96, 1e-4


def trajectory(seed: int, steps: int, at) -> dict:
    cfg = model_25m()
    tcfg = steps_mod.LMTrainConfig(objective="tb", lr=LR)
    train_step, tx = steps_mod.make_train_step(cfg, tcfg)
    step_jit = jax.jit(train_step, donate_argnums=(0, 1))
    params = steps_mod.init_lm_params(jax.random.PRNGKey(seed), cfg)
    opt_state = tx.init(params)
    pilot = synthetic_gfn_batch(cfg, BATCH, SEQ, seed=seed, step=0)
    lp, _ = jax.jit(lambda p, b: LM.forward_train(p["model"], cfg, b))(
        params, pilot)
    log_pf = jnp.sum(lp.astype(jnp.float32) * pilot["mask"], -1)
    params = dict(params, log_z=jnp.mean(pilot["log_reward"] - log_pf))
    losses = {}
    t0 = time.time()
    for step in range(steps):
        b = synthetic_gfn_batch(cfg, BATCH, SEQ, seed=seed, step=step)
        params, opt_state, metrics = step_jit(params, opt_state, b)
        if step in at:
            losses[step] = float(metrics["loss"])
    return {"seed": seed, "loss": losses,
            "finite": bool(np.all(np.isfinite(list(losses.values())))),
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--at", type=int, nargs="+", default=[0, 100, 200, 299])
    args = ap.parse_args()
    runs = []
    for seed in args.seeds:
        runs.append(trajectory(seed, args.steps, set(args.at)))
        print(json.dumps(runs[-1]), flush=True)
    at = sorted(runs[0]["loss"])
    vals = {s: [r["loss"][s] for r in runs] for s in at}
    print(json.dumps({
        "mean_loss": {s: float(np.mean(v)) for s, v in vals.items()},
        "spread_loss": {s: float(np.max(v) - np.min(v))
                        for s, v in vals.items()},
        "seeds": args.seeds}))


if __name__ == "__main__":
    main()
