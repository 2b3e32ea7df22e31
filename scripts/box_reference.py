"""The JAX package's ``box_tb`` quality trajectory: quad_tv and quad_jsd of
the recipe as registered (64 envs, MLP 4 -> 128 -> 128 -> 50, K = 4,
delta (0.1, 0.25), lr 1e-3, log Z lr 0.1, epsilon 0.1 constant), each
after a number of iterations, the reference that ``chip_smoke.py``'s
``box_converge`` phase holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/box_reference.py \\
        [--seeds 0 1 2] [--iterations 3000] [--every 750]

For each seed s (the loop's key ``PRNGKey(s)``) it prints quad_tv and
quad_jsd after every ``--every`` iterations, over the recipe's eval (8,192
non-exploring rollouts binned on the 16 x 16 grid, keyed
``PRNGKey(1000 + s)`` folded with the iteration count), one JSON line a
seed; then the mean and the spread (largest minus smallest) over the seeds
at each checkpoint.  About 20 s a seed of 3,000 iterations on a CPU; the
recipe's full budget (``--seeds 0 --iterations 30000 --every 1500``) about
3 minutes.  It runs the JAX package (the reference), not the port.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

import repro.recipes  # noqa: F401  (registers the recipes)
from repro.algo import TrainLoop
from repro.evals import QuadratureDistributionEval
from repro.recipes.base import RunOptions, get

NUM_ENVS, GRID, EVAL_SAMPLES = 64, 16, 8192


def trajectory(seed: int, iterations: int, every: int) -> dict:
    rec = get("box_tb")
    env = rec.make_env()
    env_params = env.init(jax.random.PRNGKey(0))
    policy = rec.make_policy(env)
    cfg = rec.make_config(env, RunOptions(seed=seed, iterations=iterations,
                                          num_envs=NUM_ENVS))
    ev = QuadratureDistributionEval(env, env_params, policy, grid_size=GRID,
                                    num_samples=EVAL_SAMPLES)
    run_eval = jax.jit(lambda k, p: ev(k, p))
    eval_key = jax.random.PRNGKey(1000 + seed)
    tv, jsd = {}, {}
    t0 = time.time()

    def callback(it, ts, metrics, batch):
        if (it + 1) % every == 0:
            out = run_eval(jax.random.fold_in(eval_key, it + 1), ts.params)
            tv[it + 1] = float(out["quad_tv"])
            jsd[it + 1] = float(out["quad_jsd"])
        return float(metrics["loss"])

    _, losses = TrainLoop(env, env_params, policy, cfg).run(
        jax.random.PRNGKey(seed), iterations, mode="python",
        callback=callback, callback_every=1)
    return {"seed": seed, "quad_tv": tv,
            "quad_jsd": jsd, "last_loss": losses[-1],
            "finite_losses": bool(np.all(np.isfinite(losses))),
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iterations", type=int, default=3000)
    ap.add_argument("--every", type=int, default=750)
    args = ap.parse_args()
    runs = []
    for seed in args.seeds:
        runs.append(trajectory(seed, args.iterations, args.every))
        print(json.dumps(runs[-1]), flush=True)
    checkpoints = sorted(runs[0]["quad_tv"])
    tvs = {c: [r["quad_tv"][c] for r in runs] for c in checkpoints}
    print(json.dumps({
        "mean_quad_tv": {c: float(np.mean(v)) for c, v in tvs.items()},
        "spread_quad_tv": {c: float(np.max(v) - np.min(v))
                           for c, v in tvs.items()},
        "mean_quad_jsd": {c: float(np.mean([r["quad_jsd"][c] for r in runs]))
                          for c in checkpoints},
        "seeds": args.seeds}), flush=True)


if __name__ == "__main__":
    main()
