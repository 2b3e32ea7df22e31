"""Train a registered recipe with the port (counterpart of
``python -m repro.run``).

    python -m repro_torch.run --recipe hypergrid_subtb --iterations 2000
    python -m repro_torch.run --recipe hypergrid_subtb --iterations 3 \\
        --device cpu --set dim=2 --set side=4
    python -m repro_torch.run --recipe bitseq_tb --iterations 3 \\
        --device cpu --set n=16 --set k=4 --eval-every 1
    python -m repro_torch.run --recipe amp_tb --iterations 3 \\
        --device cpu --set max_len=10

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  Each iteration prints one row: loss, ``log_z``
and ``mean_log_reward``.  Every recipe runs its evals every
``--eval-every`` iterations (default: the recipe's; 0 turns them off;
always at iteration 0), its sampling evals over ``--eval-batch`` samples
(default 2,000), and prints one ``eval`` row per evaluation at the end, as
``python -m repro.run`` does.
"""
from __future__ import annotations

import argparse
import inspect
import sys
import time
from typing import Callable, Dict, Optional

from .device import DeviceLike, resolve_device


def run_recipe(name: str, *, seed: int = 0,
               iterations: Optional[int] = None,
               num_envs: Optional[int] = None,
               env: Optional[Dict] = None, device: DeviceLike = None,
               eval_every: Optional[int] = None, eval_batch: int = 2000,
               log: Callable[[str], None] = print) -> dict:
    """Train recipe ``name``.  ``env`` overrides go to the env factory; an
    env with a reward seed takes ``seed`` unless overridden, as in the JAX
    package; the policy is drawn from ``seed`` and iteration i's noise is
    keyed on ``(seed, i)``.  ``eval_every`` (default: the recipe's; 0 turns
    evals off) runs the recipe's evals, the sampling ones over
    ``eval_batch`` samples.  Returns ``{recipe, state, history, rows, device,
    policy}``: each history row holds the iteration's metrics and
    ``wall_s``, the seconds since the loop started; ``rows`` are the eval
    rows, ``[{"step": it, metric: value, ...}]``."""
    from . import recipes
    from .algo import TrainLoop
    from .evals import EvalSuite

    recipe = recipes.get_train(name)
    dev = resolve_device(device)
    env_kwargs = dict(env or {})
    if "seed" in inspect.signature(recipe.make_env).parameters:
        env_kwargs.setdefault("seed", seed)
    environment = recipe.make_env(**env_kwargs)
    env_params = environment.init(dev)
    policy = recipe.make_policy(environment, seed=seed, device=dev,
                                requires_grad=True)
    n = recipe.iterations if iterations is None else int(iterations)
    cfg = recipe.make_config(environment, num_envs or recipe.num_envs, n)
    loop = TrainLoop(environment, env_params, policy, cfg)
    every = recipe.eval_every if eval_every is None else int(eval_every)
    suite = None
    if every > 0:
        suite = EvalSuite(recipe.make_evals(environment, env_params, policy,
                                            seed=seed, eval_batch=eval_batch),
                          every=every, seed=seed)
    t0 = time.perf_counter()

    def callback(it, state, metrics, batch):
        row = {"it": it, **{k: float(v) for k, v in metrics.items()}}
        row["wall_s"] = time.perf_counter() - t0
        log(f"it {it:6d} " + " ".join(
            f"{k} {row[k]:9.4f}" for k in ("loss", "log_z",
                                            "mean_log_reward"))
            + f" ({(it + 1) / max(row['wall_s'], 1e-9):.1f} it/s)")
        return row

    state, history = loop.run(seed, n, callback=callback, suite=suite)
    rows = [] if suite is None else suite.rows()
    for row in rows:
        log(f"eval it {row['step']:6d} " + " ".join(
            f"{k} {v:9.4f}" for k, v in row.items() if k != "step"))
    return {"recipe": name, "state": state, "history": history,
            "rows": rows, "device": dev, "policy": policy}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.run",
        description="Train a GFlowNet recipe with the PyTorch port.")
    ap.add_argument("--recipe", help="recipe name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list the trainable recipes")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    dest="overrides", help="env-factory override")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every N iterations (default: the "
                         "recipe's; 0 turns evals off)")
    ap.add_argument("--eval-batch", type=int, default=2000,
                    help="samples of the sampling evals (default 2000)")
    args = ap.parse_args(argv)

    from . import recipes
    if args.list:
        for name in recipes.train_names():
            print(f"{name:16s} {recipes.get_train(name).description}")
        return 0
    if not args.recipe:
        ap.error("--recipe is required (or --list)")
    out = run_recipe(args.recipe, seed=args.seed,
                     iterations=args.iterations, num_envs=args.num_envs,
                     env=recipes.parse_overrides(args.overrides, ap.error),
                     device=args.device, eval_every=args.eval_every,
                     eval_batch=args.eval_batch)
    print(f"trained {args.recipe} for {len(out['history'])} iterations on "
          f"{out['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
