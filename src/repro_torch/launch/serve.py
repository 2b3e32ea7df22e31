"""Sampling service of the port from the command line (port of
``repro.launch.serve``).

One-shot sampling::

    python -m repro_torch.launch.serve --env bitseq --num-samples 4 --seed 7
    python -m repro_torch.launch.serve --env hypergrid --smoke --device cpu
    python -m repro_torch.launch.serve --env bitseq \\
        --checkpoint checkpoints/bitseq_tb --num-samples 64 \\
        --temperature 0.8 --reward-beta 2.0 --json

The HTTP endpoint (POST /sample, GET /envs, /healthz, /stats; see
:mod:`repro_torch.serve.api`), behind the threaded front; SIGTERM drains
(stop admitting, finish in-flight lanes, flush responses)::

    python -m repro_torch.launch.serve --http --port 8777 \\
        --deadline 30 --max-queue 64

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  The policy is freshly initialised from seed 0,
or read from a training checkpoint of either package (``--checkpoint
DIR``, at ``--step N`` or the latest complete step, which the front
follows as training writes newer ones).  ``--plan data_parallel
--devices D`` shards every engine's lane pool over ``cuda:0 .. cuda:D-1``
(defaults ``REPRO_SERVE_PLAN`` / ``REPRO_SERVE_DEVICES``); the samples are
bitwise the single pool's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Sample GFlowNet trajectories with the PyTorch port.")
    ap.add_argument("--env", default=None, metavar="NAME",
                    help="registered environment to sample (see python -m "
                         "repro_torch.run --list-envs)")
    ap.add_argument("--num-samples", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="request seed (same seed => same samples, "
                         "regardless of batching)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="forward-logit scale of this request's lanes")
    ap.add_argument("--reward-beta", type=float, default=1.0,
                    help="reward exponent beta (R -> R^beta)")
    ap.add_argument("--transform", action="append", metavar="SPEC",
                    dest="transforms",
                    help="env transform spec, repeatable (as in "
                         "repro_torch.run)")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    dest="overrides", help="env-factory override")
    ap.add_argument("--smoke", action="store_true",
                    help="apply the env's registered smoke_overrides "
                         "(seconds-scale instance)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="checkpoint directory to load policy params from "
                         "(default: fresh-initialized policy)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest complete)")
    ap.add_argument("--lanes", type=int, default=16,
                    help="engine lane-pool size")
    ap.add_argument("--plan", default=None, choices=("single",
                                                     "data_parallel"),
                    help="execution plan for every engine's lane pool: "
                         "data_parallel shards lanes over the devices, "
                         "bitwise-identical samples (default: "
                         "REPRO_SERVE_PLAN env var, else single)")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count for --plan data_parallel (default: "
                         "REPRO_SERVE_DEVICES env var, else all visible "
                         "devices)")
    ap.add_argument("--dedup-cache", type=int, default=64, metavar="N",
                    help="per-engine LRU of recent results served to "
                         "identical requests (env, transforms, checkpoint "
                         "step, seed, temperatures, num_samples); 0 "
                         "disables dedup")
    ap.add_argument("--autosize", action="store_true",
                    help="grow/shrink each engine's lane pool between "
                         "requests across power-of-two buckets sized to "
                         "the EWMA arrival-rate demand estimate")
    ap.add_argument("--min-lanes", type=int, default=2,
                    help="autosizing lower bucket bound")
    ap.add_argument("--max-lanes", type=int, default=None,
                    help="autosizing upper bucket bound (default: "
                         "max(64, --lanes))")
    ap.add_argument("--prewarm", action="store_true",
                    help="run a block at every autosize bucket when an "
                         "engine is built")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="print the SampleResult as JSON")
    ap.add_argument("--http", action="store_true",
                    help="run the HTTP JSON endpoint instead of a "
                         "one-shot request")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="per-engine admission queue bound; a full queue "
                         "returns 503 + Retry-After (backpressure)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="default per-request deadline: 408 if it expires "
                         "while queued, 504 with partial progress if it "
                         "expires mid-execution (default: none)")
    ap.add_argument("--max-samples", type=int, default=4096,
                    help="per-request num_samples bound (400 beyond it)")
    ap.add_argument("--retries", type=int, default=2,
                    help="transient engine-step failures retried (with "
                         "backoff) before the engine is quarantined and "
                         "rebuilt")
    ap.add_argument("--checkpoint-poll", type=float, default=1.0,
                    metavar="SEC",
                    help="how often to probe step=None checkpoint dirs "
                         "for newer complete checkpoints (engine refresh); "
                         "0 disables")
    ap.add_argument("--max-inflight-per-client", type=int, default=None,
                    help="per-client concurrent request cap (429 beyond "
                         "it; default: unlimited)")
    ap.add_argument("--single-thread", action="store_true",
                    help="serve the blocking single-threaded endpoint "
                         "instead of the concurrent front")
    args = ap.parse_args(argv)

    from .. import recipes
    from ..serve import SampleRequest, Scheduler, ServeFront, serve_http

    try:
        sched = Scheduler(num_lanes=args.lanes, device=args.device,
                          max_step_retries=args.retries, plan=args.plan,
                          devices=args.devices,
                          dedup_cache_size=args.dedup_cache)
    except ValueError as e:       # a plan or device count this box lacks
        ap.error(str(e))
    if args.http:
        return _serve_http(args, sched, ServeFront, serve_http)

    if args.env is None:
        ap.error("--env is required (or --http for the endpoint)")
    try:
        recipe = recipes.get(args.env)
    except KeyError as e:
        ap.error(str(e.args[0]))
    overrides = dict(recipe.smoke_overrides) if args.smoke else {}
    overrides.update(recipes.parse_overrides(args.overrides, ap.error))
    req = SampleRequest(env=args.env, num_samples=args.num_samples,
                        seed=args.seed, logit_temp=args.temperature,
                        reward_beta=args.reward_beta,
                        transforms=tuple(args.transforms or ()),
                        overrides=overrides, checkpoint=args.checkpoint,
                        step=args.step)
    t0 = time.perf_counter()
    rid = sched.submit(req)
    results = sched.run(only=(rid,))
    dt = time.perf_counter() - t0
    if rid not in results:
        print("error: the engine drained without completing the request",
              file=sys.stderr)
        return 1
    result = results[rid]
    if args.json:
        print(json.dumps(result.to_dict()))
        return 0
    print(f"sampled {len(result.samples)} x {args.env} on {sched.device} in "
          f"{dt:.2f}s (engine latency {result.latency_s:.2f}s, "
          f"{len(result.samples) / dt:.1f} samples/s)")
    for i, (s, lr, st) in enumerate(zip(result.samples, result.log_rewards,
                                        result.steps)):
        print(f"  [{i}] log_r={lr:9.3f} steps={st:3d} obs={str(s)[:60]}")
    return 0


def _serve_http(args, sched, front_cls, serve_http) -> int:
    """The endpoint until SIGTERM (drain) or ctrl-c."""
    if args.single_thread:
        target = sched
    else:
        target = front_cls(
            sched, max_queue=args.max_queue,
            default_deadline_s=args.deadline,
            max_num_samples=args.max_samples,
            max_inflight_per_client=args.max_inflight_per_client,
            checkpoint_poll_s=(args.checkpoint_poll or None),
            autosize=args.autosize, min_lanes=args.min_lanes,
            max_lanes=args.max_lanes, prewarm_lanes=args.prewarm)
    serve_http(target, host=args.host, port=args.port,
               log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
