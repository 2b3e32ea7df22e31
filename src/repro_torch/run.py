"""Train a registered recipe with the port (counterpart of
``python -m repro.run``).

    python -m repro_torch.run --recipe bitseq_tb --iterations 100 --seed 0
    python -m repro_torch.run --recipe bitseq_tb --iterations 3 \\
        --device cpu --set n=16 --set k=4

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  Each iteration prints one row: loss, ``log_z``
and ``mean_log_reward``.  The recipe's evals (which need backward
rollouts) are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional

from .device import DeviceLike, resolve_device


def run_recipe(name: str, *, seed: int = 0,
               iterations: Optional[int] = None,
               num_envs: Optional[int] = None,
               env: Optional[Dict] = None, device: DeviceLike = None,
               log: Callable[[str], None] = print) -> dict:
    """Train recipe ``name``.  ``env`` overrides go to the env factory; the
    env's reward seed follows ``seed`` unless overridden, as in the JAX
    package; the policy is drawn from ``seed`` and iteration i's noise is
    keyed on ``(seed, i)``.  Returns ``{recipe, state, history, device,
    policy}``;
    each history row holds the iteration's metrics and ``wall_s``, the
    seconds since the loop started."""
    from . import recipes
    from .algo import TrainLoop

    recipe = recipes.get_train(name)
    dev = resolve_device(device)
    env_kwargs = {"seed": seed, **(env or {})}
    environment = recipe.make_env(**env_kwargs)
    env_params = environment.init(dev)
    policy = recipe.make_policy(environment, seed=seed, device=dev,
                                requires_grad=True)
    cfg = recipe.make_config(environment,
                             num_envs or recipe.num_envs)
    loop = TrainLoop(environment, env_params, policy, cfg)
    n = recipe.iterations if iterations is None else int(iterations)
    t0 = time.perf_counter()

    def callback(it, state, metrics, batch):
        row = {"it": it, **{k: float(v) for k, v in metrics.items()}}
        row["wall_s"] = time.perf_counter() - t0
        log(f"it {it:6d} " + " ".join(
            f"{k} {row[k]:9.4f}" for k in ("loss", "log_z",
                                            "mean_log_reward"))
            + f" ({(it + 1) / max(row['wall_s'], 1e-9):.1f} it/s)")
        return row

    state, history = loop.run(seed, n, callback=callback)
    return {"recipe": name, "state": state, "history": history,
            "device": dev, "policy": policy}


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
    args = ap.parse_args(argv)

    from . import recipes
    if args.list:
        for name in recipes.train_names():
            print(f"{name:12s} {recipes.get_train(name).description}")
        return 0
    if not args.recipe:
        ap.error("--recipe is required (or --list)")
    out = run_recipe(args.recipe, seed=args.seed,
                     iterations=args.iterations, num_envs=args.num_envs,
                     env=recipes.parse_overrides(args.overrides, ap.error),
                     device=args.device)
    print(f"trained {args.recipe} for {len(out['history'])} iterations on "
          f"{out['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
