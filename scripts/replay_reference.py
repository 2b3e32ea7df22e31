"""The JAX package's ``hypergrid_tb`` trajectory under reward-prioritized
replay: exact-DP TV and JSD of the learned sampler against the target,
each after a number of iterations, the reference that ``chip_smoke.py``'s
``replay_converge`` phase holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/replay_reference.py \\
        [--seeds 0 1 2] [--iterations 1500] [--every 500]

The run is ``python -m repro.run --recipe hypergrid_tb --sampler replay
--replay-capacity 4096 --prioritized`` cut to ``--iterations``: the 4x8^4
grid, an MLP 2x256 with the uniform P_B, 16 envs, lr 1e-3, log Z lr 0.1,
epsilon 0.1 annealed over half the iterations; each iteration adds its 16
terminals to a 4,096-slot FIFO and replays 16 drawn by softmax over the
stored log-rewards (temperature 1).  For each seed s (the loop's key
``PRNGKey(s)``) it prints exact_tv and exact_jsd after every ``--every``
iterations (the exact DP over the 4,096 terminals), one JSON line a seed;
then the mean and the spread (largest minus smallest) over the seeds at
each checkpoint.  It runs the JAX package (the reference), not the port.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

import repro.recipes  # noqa: F401  (registers the recipes)
from repro.algo import ReplaySampler, TrainLoop
from repro.evals import ExactDistributionEval
from repro.recipes.base import RunOptions, get

NUM_ENVS, CAPACITY = 16, 4096


def trajectory(seed: int, iterations: int, every: int) -> dict:
    rec = get("hypergrid_tb")
    env = rec.make_env()
    env_params = env.init(jax.random.PRNGKey(seed))
    policy = rec.make_policy(env)
    cfg = rec.make_config(env, RunOptions(seed=seed, iterations=iterations,
                                          num_envs=NUM_ENVS))
    ev = ExactDistributionEval(env, env_params, policy.apply)
    run_eval = jax.jit(lambda p: ev(None, p))
    tv, jsd = {}, {}
    t0 = time.time()

    def callback(it, ts, metrics, batch):
        if (it + 1) % every == 0:
            out = run_eval(ts.params)
            tv[it + 1] = float(out["exact_tv"])
            jsd[it + 1] = float(out["exact_jsd"])
        return float(metrics["loss"])

    loop = TrainLoop(env, env_params, policy, cfg,
                     sampler=ReplaySampler(capacity=CAPACITY,
                                           prioritized=True))
    _, losses = loop.run(jax.random.PRNGKey(seed), iterations,
                         mode="python", callback=callback, callback_every=1)
    return {"seed": seed, "exact_tv": tv, "exact_jsd": jsd,
            "last_loss": losses[-1],
            "finite_losses": bool(np.all(np.isfinite(losses))),
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iterations", type=int, default=1500)
    ap.add_argument("--every", type=int, default=500)
    args = ap.parse_args()
    runs = []
    for seed in args.seeds:
        runs.append(trajectory(seed, args.iterations, args.every))
        print(json.dumps(runs[-1]), flush=True)
    checkpoints = sorted(runs[0]["exact_tv"])
    tvs = {c: [r["exact_tv"][c] for r in runs] for c in checkpoints}
    print(json.dumps({
        "mean_exact_tv": {c: float(np.mean(v)) for c, v in tvs.items()},
        "spread_exact_tv": {c: float(np.max(v) - np.min(v))
                            for c, v in tvs.items()}}), flush=True)


if __name__ == "__main__":
    main()
