"""The JAX package's EB-GFN quality trajectory at the quick Table 8
configuration (``benchmarks/quality.py`` ``table8_ising_ebgfn(quick=True)``:
n = 4, sigma = 0.2, 500 Wolff samples from seed 0, MLP 2x256 with a
learned P_B, 64 envs, 800 iterations), the reference that ``chip_smoke.py``'s
``ising_converge`` phase holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ising_reference.py \\
        [--seeds 0 1 2]

For each seed s (the policy's and the loop's key ``PRNGKey(s)``, the data
rows' ``RandomState(s)``) it prints -log RMSE of the learned J after 200,
400, 600 and 800 iterations and the last MH acceptance, then the mean over
the seeds at each checkpoint, one JSON line each.  About 20-25 s a seed on
a CPU.  It runs the JAX package (the reference), not the port.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from repro.core.ebgfn import make_ebgfn_step, neg_log_rmse
from repro.core.policies import make_mlp_policy
from repro.envs.ising import IsingEnvironment, generate_ising_dataset

N, SIGMA, NUM_DATA, NUM_ENVS, HIDDEN = 4, 0.2, 500, 64, (256, 256)
CHECKPOINTS = (200, 400, 600, 800)


def trajectory(seed: int) -> dict:
    env = IsingEnvironment(n=N, sigma=SIGMA)
    J_true = env.init(jax.random.PRNGKey(0))["J"]
    data = jax.numpy.asarray(generate_ising_dataset(0, N, SIGMA,
                                                    num_samples=NUM_DATA))
    pol = make_mlp_policy(env.D, env.action_dim, env.backward_action_dim,
                          hidden=HIDDEN, learn_backward=True)
    init_fn, step_fn = make_ebgfn_step(env, pol, num_envs=NUM_ENVS)
    st = init_fn(jax.random.PRNGKey(seed), data)
    step_fn = jax.jit(step_fn)
    rng = np.random.RandomState(seed)
    scores, t0 = {}, time.time()
    for it in range(CHECKPOINTS[-1]):
        st, m = step_fn(st, data[rng.randint(0, data.shape[0], NUM_ENVS)])
        if it + 1 in CHECKPOINTS:
            scores[it + 1] = float(neg_log_rmse(st.ebm_params["J"], J_true))
    return {"seed": seed, "neg_log_rmse": scores,
            "mh_accept": float(m["mh_accept"]),
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    runs = []
    for seed in args.seeds:
        runs.append(trajectory(seed))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"mean_neg_log_rmse": {
        c: float(np.mean([r["neg_log_rmse"][c] for r in runs]))
        for c in CHECKPOINTS}, "seeds": args.seeds}), flush=True)


if __name__ == "__main__":
    main()
