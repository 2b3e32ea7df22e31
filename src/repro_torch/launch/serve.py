"""One-shot sampling from the port's serving tier.

    python -m repro_torch.launch.serve --env bitseq --num-samples 4 --seed 7
    python -m repro_torch.launch.serve --env bitseq --smoke --device cpu
    python -m repro_torch.launch.serve --env bitseq \\
        --checkpoint checkpoints/bitseq_tb --num-samples 4

Runs on ``cuda`` unless ``--device cpu`` is given; fails on a machine
without a GPU otherwise.  The policy is freshly initialised from seed 0,
or read from a training checkpoint of either package (``--checkpoint
DIR``, at ``--step N`` or the latest complete step).  Refreshing onto a
newer checkpoint while serving (JAX's ``--checkpoint-poll``) is not
ported.
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
    ap.add_argument("--env", required=True, metavar="NAME",
                    help="servable environment (bitseq)")
    ap.add_argument("--num-samples", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="request seed (same seed => same samples, "
                         "regardless of batching)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="forward-logit scale of this request's lanes")
    ap.add_argument("--reward-beta", type=float, default=1.0,
                    help="reward exponent beta (R -> R^beta)")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    dest="overrides", help="env-factory override")
    ap.add_argument("--smoke", action="store_true",
                    help="use the env's seconds-scale smoke instance")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="checkpoint directory to load policy params from "
                         "(default: fresh-initialized policy)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest complete)")
    ap.add_argument("--lanes", type=int, default=16,
                    help="engine lane-pool size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="print the SampleResult as JSON")
    args = ap.parse_args(argv)

    from .. import recipes
    from ..serve import SampleRequest, Scheduler

    overrides = dict(recipes.get(args.env).smoke_overrides) \
        if args.smoke else {}
    overrides.update(recipes.parse_overrides(args.overrides, ap.error))

    sched = Scheduler(num_lanes=args.lanes, device=args.device)
    req = SampleRequest(env=args.env, num_samples=args.num_samples,
                        seed=args.seed, logit_temp=args.temperature,
                        reward_beta=args.reward_beta, overrides=overrides,
                        checkpoint=args.checkpoint, step=args.step)
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
          f"{dt:.2f}s ({len(result.samples) / dt:.1f} samples/s)")
    for i, (s, lr, st) in enumerate(zip(result.samples, result.log_rewards,
                                        result.steps)):
        print(f"  [{i}] log_r={lr:9.3f} steps={st:3d} obs={str(s)[:60]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
