"""Train a registered recipe with the port (counterpart of
``python -m repro.run``).

    python -m repro_torch.run --list
    python -m repro_torch.run --list-envs
    python -m repro_torch.run --recipe hypergrid_subtb --iterations 2000
    python -m repro_torch.run --recipe hypergrid_subtb --iterations 3 \\
        --device cpu --set dim=2 --set side=4 --cfg lr=3e-4
    python -m repro_torch.run --recipe bitseq_tb --iterations 3 \\
        --device cpu --set n=16 --set k=4 --eval-every 1
    python -m repro_torch.run --recipe ising_ebgfn --iterations 3 \\
        --device cpu --set n=3 --set num_data=50
    python -m repro_torch.run --recipe hypergrid_tb --sampler replay \\
        --replay-capacity 4096 --prioritized

    # registered env x transform stack x objective (the env registry)
    python -m repro_torch.run --env hypergrid --transform beta=2.0
    python -m repro_torch.run --env tfbind8 --transform reward_cache \\
        --transform "reward_exponent:beta=0.5" --iterations 200

    # checkpoint every 1000 iterations, resume after an interruption
    python -m repro_torch.run --recipe hypergrid_tb --checkpoint-every 1000
    python -m repro_torch.run --recipe hypergrid_tb --checkpoint-every 1000 \\
        --restore

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  On CUDA it trains as JAX's CLI does, on the
compiled step: the first iteration runs eagerly and every later one
replays a CUDA graph of it (``TrainLoop.run``'s python mode).  Each
iteration prints one row: loss, ``log_z`` and ``mean_log_reward``.  Every
recipe runs its evals every ``--eval-every`` iterations (default: the
recipe's; 0 turns them off; always at iteration 0), its sampling evals
over ``--eval-batch`` samples (default 2,000), and prints one ``eval`` row
per evaluation at the end; ``--metrics-json`` writes those rows in JAX's
schema 1 (:func:`dump_metrics_json`).  ``ising_ebgfn`` runs its own loop
(EB-GFN, the recipe's ``run_override``): it prints JAX's rows
(``gfn_loss``, ``-logRMSE``, ``mh_accept``) at every ``--eval-every``-th
iteration and the last.

Checkpoints are written in the JAX package's format and leaf names
(:mod:`repro_torch.checkpoint`), so a run moves between the packages: the
port resumes a JAX checkpoint (params, Adam moments and count, step,
buffer, eval rows; JAX's threefry ``.train/.key`` cannot be continued, so
from there on the port draws its own noise, iteration i from ``(seed,
i)``), a port resume is bitwise the uninterrupted port run, and JAX's
serving loader (``restore_subtree``) reads a port checkpoint's policy
params.  JAX's full ``restore`` of a port checkpoint is not possible: the
port writes no ``.train/.key``.

Execution plans, with JAX's flags (:mod:`repro_torch.algo.plan`)::

    # 8 independent seeds on one card, each kernel launched once for all 8
    python -m repro_torch.run --recipe hypergrid_subtb --plan vmap_seeds \
        --num-seeds 8
    # the batch over D ranks: started here as D processes (rank r on
    # cuda:r, or all on the CPU over gloo with --device cpu) unless
    # torchrun started this one
    python -m repro_torch.run --recipe hypergrid_tb --plan data_parallel \
        --devices 4 --device cpu

Seed s of a seed plan seeded ``--seed k`` is the single run ``--seed
k+s`` (:func:`repro_torch.algo.plan.seed_of`); its rows print the mean over
the seeds, and seed plans run no evals.  ``data_parallel`` over two or more
ranks needs a card per rank (NCCL refuses two ranks on one device), or
``--device cpu``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from .device import DeviceLike, resolve_device


#: version of the --metrics-json document layout (JAX's)
METRICS_SCHEMA_VERSION = 1


def dump_metrics_json(path: str, *, recipe: str, opts, suite,
                      rows: list) -> dict:
    """Write the metrics document ``benchmarks/quality.py`` reads, in the
    JAX package's schema 1::

        {"schema_version": 1, "recipe": str, "seed": int,
         "iterations": int, "eval_every": int, "eval_batch": int,
         "metric_names": [str, ...],
         "rows": [{"step": int, <metric>: float, ...}, ...]}
    """
    doc = {"schema_version": METRICS_SCHEMA_VERSION,
           "recipe": recipe,
           "seed": opts.seed,
           "iterations": opts.iterations,
           "eval_every": opts.eval_every,
           "eval_batch": opts.eval_batch,
           "metric_names": list(suite.metric_names),
           "rows": rows}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def run_recipe(name: Optional[str] = None, *, seed: int = 0,
               env_name: Optional[str] = None, transforms=(),
               iterations: Optional[int] = None,
               num_envs: Optional[int] = None,
               env: Optional[Dict] = None, config: Optional[Dict] = None,
               device: DeviceLike = None,
               eval_every: Optional[int] = None,
               eval_batch: Optional[int] = None,
               sampler=None, sampler_kwargs: Optional[dict] = None,
               metrics_json: Optional[str] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, restore: bool = False,
               plan="single", devices=None,
               num_seeds: Optional[int] = None,
               log: Callable[[str], None] = print) -> dict:
    """Train recipe ``name``, or the default recipe of the registered env
    ``env_name`` (:mod:`repro_torch.envs.registry`), whose factory then
    replaces the recipe's ``make_env``.  ``transforms`` is a stack of
    :mod:`repro_torch.envs.transforms` specs (innermost first) wrapped
    around the env before ``init``.  ``env`` overrides go to the env
    factory; an env with a reward seed takes ``seed`` unless overridden,
    as in the JAX package.  ``config`` overrides go to the recipe's
    ``GFNConfig`` (``_replace``).  The policy is drawn from ``seed`` and
    iteration i's noise is keyed on ``(seed, i)``.  ``eval_every``
    (default: the recipe's; 0 turns evals off) runs the recipe's evals,
    the sampling ones over ``eval_batch`` samples; ``metrics_json`` writes
    their rows (:func:`dump_metrics_json`).  ``sampler`` (a registry name
    of :data:`repro_torch.algo.SAMPLERS` or a sampler; default the
    recipe's) is built with ``sampler_kwargs``.  ``checkpoint_every > 0``
    saves the state into ``checkpoint_dir`` (default
    ``checkpoints/<recipe>``) on that cadence and at the end;
    ``restore=True`` resumes from the newest complete checkpoint there.
    ``plan`` / ``devices`` / ``num_seeds`` pick the execution plan
    (:func:`repro_torch.algo.plan.make_plan`): under a seed plan seed s is
    the single run seeded ``seed + s``, the rows hold the mean over the
    seeds and no evals run (a metrics JSON is refused with JAX's warning);
    under a data-parallel plan this process is one rank of a running
    group, or of a group of one that it starts (``python -m
    repro_torch.run`` starts D ranks), on ``cuda:<rank>`` unless ``device``
    names one, and only rank 0 records evals and writes checkpoints.
    A recipe with a run function of its own (``run_override``) refuses a
    foreign env, a sampler, any plan but single and the checkpoint flags,
    and warns that it writes no metrics JSON, as in JAX.  Returns ``{recipe, state,
    history, rows, device, policy, loop, suite}``: each history row holds the
    iteration's metrics and ``wall_s``, the seconds since the loop
    started; ``rows`` are the eval rows, ``[{"step": it, metric: value,
    ...}]``; ``loop.captured`` is the run's captured iteration on CUDA
    (its launches per replay and its replays)."""
    from . import recipes
    from .algo import TrainLoop, make_sampler
    from .algo.plan import make_plan
    from .checkpoint import CheckpointManager
    from .envs.registry import get_env
    from .envs.transforms import apply_transforms, transform_stack
    from .evals import EvalSuite

    entry = None
    if env_name is not None:
        entry = get_env(env_name)
        if name is None:
            name = entry.recipe
    if name is None:
        raise ValueError("run_recipe needs a recipe name or an env_name "
                         "whose registry entry supplies one")
    recipe = recipes.get_train(name)
    exec_plan = make_plan(plan, devices=devices, num_seeds=num_seeds,
                          num_envs=num_envs or recipe.num_envs)
    if exec_plan.shard_info().axis is not None and \
            torch.device(device or "cuda") == torch.device("cuda"):
        device = f"cuda:{exec_plan.rank}"       # rank r takes cuda:r
    dev = resolve_device(device)
    opts = recipes.RunOptions(
        seed=seed,
        iterations=recipe.iterations if iterations is None
        else int(iterations),
        num_envs=num_envs or recipe.num_envs,
        eval_every=recipe.eval_every if eval_every is None
        else int(eval_every),
        eval_batch=recipes.RunOptions.eval_batch if eval_batch is None
        else int(eval_batch),
        transforms=tuple(transforms))
    if recipe.run_override is not None:
        if entry is not None and entry.recipe != recipe.name:
            # the run function builds its own env: a foreign --env would
            # be ignored without a word
            raise ValueError(
                f"recipe {recipe.name!r} runs a training loop of its own "
                f"that constructs its own environment; --env "
                f"{env_name!r} cannot replace it (drop --recipe to use "
                f"that env's default recipe {entry.recipe!r})")
        if sampler is not None:
            raise ValueError(
                f"recipe {recipe.name!r} runs a training loop of its own; "
                "--sampler is not supported for it")
        if exec_plan.name != "single":
            raise ValueError(
                f"recipe {recipe.name!r} uses a custom training driver; "
                "--plan/--checkpoint-every/--restore are not supported "
                "for it")
        if checkpoint_every or restore:
            raise ValueError(
                f"recipe {recipe.name!r} runs a training loop of its own; "
                "--checkpoint-every/--restore are not supported for it")
        if metrics_json is not None:
            log(f"warning: recipe {recipe.name!r} uses a custom training "
                "loop without an eval suite; --metrics-json is ignored")
        return recipe.run_override(
            seed=seed, iterations=opts.iterations, num_envs=opts.num_envs,
            env=dict(env or {}), device=dev, eval_every=opts.eval_every,
            log=log, config=dict(config or {}),
            transforms=opts.transforms)
    env_kwargs = dict(env or {})
    make_env = entry.make if entry is not None else recipe.make_env
    if "seed" in inspect.signature(make_env).parameters:
        env_kwargs.setdefault("seed", seed)
    environment = make_env(**env_kwargs)
    if opts.transforms:
        environment = apply_transforms(environment, opts.transforms)
        log(f"transforms: {' > '.join(transform_stack(environment))} "
            f"(outermost first)")
    env_params = environment.init(dev)
    policy = recipe.make_policy(environment, seed=seed, device=dev,
                                requires_grad=True)
    cfg = recipe.make_config(environment, opts.num_envs, opts.iterations)
    if config:
        cfg = cfg._replace(**config)
    if exec_plan.name != "single":
        log(f"plan: {exec_plan.name} over {exec_plan.device_count} "
            f"device(s), mesh_shape={exec_plan.mesh_shape}, "
            f"num_seeds={exec_plan.seeds}")
    seed_params = None
    if exec_plan.seeds:
        seed_params = (lambda sd: recipe.make_policy(
            environment, seed=sd, device=dev).params.flat())
    loop = TrainLoop(environment, env_params, policy, cfg,
                     sampler=make_sampler(sampler or "on_policy",
                                          **(sampler_kwargs or {})),
                     plan=exec_plan, seed_params=seed_params)
    suite = None
    # seed plans carry a per-seed metric axis the rows do not flatten:
    # evals run on the unseeded plans only, as in JAX
    if opts.eval_every > 0 and not exec_plan.seeds:
        suite = EvalSuite(recipe.make_evals(environment, env_params, policy,
                                            seed=seed,
                                            eval_batch=opts.eval_batch),
                          every=opts.eval_every, seed=seed)
    elif exec_plan.seeds and metrics_json is not None:
        log(f"warning: plan {exec_plan.name!r} carries a per-seed metric "
            "axis the eval suite does not flatten; --metrics-json is "
            "ignored")
    manager = None
    if checkpoint_every > 0 or restore:
        manager = CheckpointManager(checkpoint_dir
                                    or f"checkpoints/{recipe.name}")
    t0 = time.perf_counter()

    def callback(it, state, metrics, batch):
        # seed plans report per-seed metrics; the row takes their mean
        row = {"it": it, **{k: float(v.mean()) for k, v in metrics.items()}}
        row["wall_s"] = time.perf_counter() - t0
        log(f"it {it:6d} " + " ".join(
            f"{k} {row[k]:9.4f}" for k in ("loss", "log_z",
                                            "mean_log_reward"))
            + f" ({(it + 1) / max(row['wall_s'], 1e-9):.1f} it/s)")
        return row

    state, history = loop.run(seed, opts.iterations, callback=callback,
                              suite=suite, checkpoint=manager,
                              checkpoint_every=checkpoint_every,
                              restore=restore)
    rows = [] if suite is None or loop.rank != 0 else suite.rows()
    for row in rows:
        log(f"eval it {row['step']:6d} " + " ".join(
            f"{k} {v:9.4f}" for k, v in row.items() if k != "step"))
    if suite is not None and loop.rank == 0 and metrics_json is not None:
        dump_metrics_json(metrics_json, recipe=recipe.name, opts=opts,
                          suite=suite, rows=rows)
        log(f"wrote metrics JSON -> {metrics_json}")
    return {"recipe": recipe.name, "state": state, "history": history,
            "rows": rows, "device": dev, "policy": policy, "loop": loop,
            "suite": suite}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.run",
        description="Train a GFlowNet recipe with the PyTorch port.")
    ap.add_argument("--recipe", help="recipe name (see --list)")
    ap.add_argument("--env", dest="env_name", default=None, metavar="NAME",
                    help="registered environment (see --list-envs); its "
                         "factory replaces the recipe's make_env and, "
                         "without --recipe, its default recipe drives the "
                         "run")
    ap.add_argument("--transform", action="append", metavar="SPEC",
                    dest="transforms",
                    help="env transform applied innermost-first; SPEC is "
                         "name[:k=v,...] (reward_exponent | reward_cache | "
                         "time_limit | identity) or the beta=2.0 shorthand "
                         "for reward_exponent; repeatable to stack")
    ap.add_argument("--list", action="store_true",
                    help="list registered recipes and exit")
    ap.add_argument("--list-envs", action="store_true",
                    help="list registered environments and exit")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None,
                    help="iterations between evaluation rows (default: "
                         "the recipe's; 0 disables evaluation)")
    ap.add_argument("--eval-batch", type=int, default=None,
                    help="sample count for sampling evaluators (default "
                         "2000)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the eval-suite metric rows as JSON "
                         "(consumed by benchmarks/quality.py)")
    ap.add_argument("--plan", default="single",
                    choices=["auto", "single", "data_parallel",
                             "vmap_seeds", "seeds_x_data"],
                    help="execution plan: 'data_parallel' shards rollouts "
                         "and objectives over --devices ranks (started "
                         "here, rank r on cuda:r, or on the CPU over gloo "
                         "with --device cpu, unless torchrun started this "
                         "process); 'auto' does so whenever >1 device is "
                         "visible and the batch divides evenly; "
                         "'vmap_seeds' trains --num-seeds runs at once")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks for data_parallel/seeds_x_data (default: "
                         "all visible devices)")
    ap.add_argument("--num-seeds", type=int, default=None,
                    help="seed-axis size for vmap_seeds/seeds_x_data plans")
    ap.add_argument("--checkpoint-dir", default=None, metavar="PATH",
                    help="checkpoint directory "
                         "(default checkpoints/<recipe>)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save the full loop state every N iterations "
                         "(0 = off)")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest complete checkpoint in "
                         "the checkpoint directory")
    ap.add_argument("--sampler", default=None,
                    choices=["on_policy", "eps_noisy", "replay",
                             "backward_replay"],
                    help="override the recipe's trajectory sampler")
    ap.add_argument("--replay-capacity", type=int, default=2048)
    ap.add_argument("--replay-batch", type=int, default=None)
    ap.add_argument("--prioritized", action="store_true",
                    help="reward-prioritized replay sampling")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="prioritized-replay softmax temperature")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    dest="env_overrides",
                    help="environment override, forwarded to make_env")
    ap.add_argument("--cfg", action="append", metavar="KEY=VALUE",
                    dest="config_overrides",
                    help="GFNConfig override (e.g. lr=3e-4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)

    from . import recipes
    from .envs.registry import env_names, get_env
    from .envs.transforms import parse_transform

    if args.list_envs:
        entries = [get_env(n) for n in env_names()]
        width = max((len(e.name) for e in entries), default=0)
        rwidth = max((len(e.recipe) for e in entries), default=0)
        swidth = max((len(e.serving) for e in entries), default=0)
        awidth = max((len(e.action_space) for e in entries), default=0)
        for e in entries:
            print(f"{e.name:<{width}}  recipe={e.recipe:<{rwidth}}  "
                  f"actions={e.action_space:<{awidth}}  "
                  f"serving={e.serving:<{swidth}}  "
                  f"transforms={','.join(e.transforms)}  {e.description}")
        return 0

    if args.list or not (args.recipe or args.env_name):
        width = max((len(n) for n in recipes.train_names()), default=0)
        for n in recipes.train_names():
            print(f"{n:<{width}}  {recipes.get_train(n).description}")
        return 0

    if args.env_name is not None:
        try:
            entry = get_env(args.env_name)
        except KeyError:
            print(f"error: unknown env {args.env_name!r}; run --list-envs "
                  "to see the registry", file=sys.stderr)
            return 2
        # one clear line instead of a construction-time traceback (e.g.
        # reward_cache on a continuous env)
        supported = {t.partition(":")[0] for t in entry.transforms}
        for spec in args.transforms or ():
            try:
                tname, _ = parse_transform(spec)
            except (KeyError, ValueError) as e:
                print(f"error: bad transform spec {spec!r}: {e}",
                      file=sys.stderr)
                return 2
            if tname not in supported:
                print(f"error: env {args.env_name!r} does not support "
                      f"transform {tname!r} (supported: "
                      f"{', '.join(sorted(supported))}); see the "
                      "transforms column of --list-envs", file=sys.stderr)
                return 2
    if args.recipe is not None:
        try:
            recipes.get_train(args.recipe)
        except KeyError:
            print(f"error: unknown recipe {args.recipe!r}; run --list to "
                  "see the registry", file=sys.stderr)
            return 2

    from .algo.plan import make_plan
    from .launch import mesh
    try:
        plan = make_plan(args.plan, devices=args.devices,
                         num_seeds=args.num_seeds,
                         num_envs=args.num_envs
                         or recipes.get_train(args.recipe
                                              or get_env(args.env_name).recipe
                                              ).num_envs)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    world = plan.num_shards
    if plan.shard_info().axis is not None and world > 1 \
            and not mesh.under_launcher():
        if torch.device(args.device or "cuda").type == "cuda" and \
                torch.cuda.device_count() < world:
            ap.error(f"--plan {plan.name} --devices {world} puts rank r on "
                     f"cuda:r and needs {world} CUDA devices; this machine "
                     f"has {torch.cuda.device_count()} (pass --device cpu "
                     "to run the ranks on the CPU over gloo)")
        # start the ranks, as JAX's command line runs the whole mesh
        import torch.multiprocessing as mp
        mp.start_processes(_rank_main, args=(list(sys.argv[1:] if argv is None
                                                  else argv),
                                             world, mesh.store_file()),
                           nprocs=world, start_method="spawn")
        return 0
    return _train(args, ap)


def _rank_main(rank: int, argv, world: int, store_path: str) -> None:
    """Rank ``rank`` of a ``--plan data_parallel`` run that
    :func:`main` started: join the group on its device, train, leave."""
    from .launch import mesh
    ap = _parser()
    args = ap.parse_args(argv)
    device = (torch.device("cpu") if args.device
              and torch.device(args.device).type == "cpu"
              else torch.device("cuda", rank))
    mesh.init_group(world, rank, device, store_path=store_path)
    try:
        _train(args, ap, device=device, quiet=rank != 0)
    finally:
        mesh.destroy_group()


def _train(args, ap, device=None, quiet: bool = False) -> int:
    """Train as the parsed ``args`` say (in this process: a single run, a
    seed plan, or one rank of a data-parallel group)."""
    from . import recipes
    if device is None and args.device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"    # a torchrun rank
    sampler_kwargs = {}
    if args.sampler in ("replay", "backward_replay"):
        sampler_kwargs = {"capacity": args.replay_capacity,
                          "replay_batch": args.replay_batch,
                          "prioritized": args.prioritized,
                          "temperature": args.temperature}
    out = run_recipe(
        args.recipe, seed=args.seed, env_name=args.env_name,
        transforms=tuple(args.transforms or ()),
        iterations=args.iterations, num_envs=args.num_envs,
        env=recipes.parse_overrides(args.env_overrides, ap.error),
        config=recipes.parse_overrides(args.config_overrides, ap.error),
        device=args.device if device is None else device,
        eval_every=args.eval_every,
        eval_batch=args.eval_batch, sampler=args.sampler,
        sampler_kwargs=sampler_kwargs, metrics_json=args.metrics_json,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, restore=args.restore,
        plan=args.plan, devices=args.devices, num_seeds=args.num_seeds,
        log=(lambda *_: None) if quiet else print)
    if not quiet:
        print(f"trained {out['recipe']} for {out['state'].step} iterations "
              f"on {out['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
