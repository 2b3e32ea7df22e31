#!/usr/bin/env python3
"""Time one checkout's eager (uncaptured) kernel wrappers and paths on the
card.

    python3 scripts/eager_wrappers_ab.py --checkout DIR [--reps 3]

Puts ``DIR/src`` first on the path and builds that checkout's kernels.
Then, for each of ``--reps`` rounds, times on the host's clock (a sync
after each timed block):

``call_us``    one eager call of a wrapper, over 2,000 calls issued back
               to back at a main path's shape (host-bound there): bitseq's
               rollout ``decode_attention`` (16, 16, 8, 8), ``traj_logprob``
               forward and backward through autograd at (16, 15, 3840),
               ``subtb_loss`` forward and backward at (16, 30);
``step_ms``    one eager ``TrainLoop.step`` of ``bitseq_tb`` and of
               ``hypergrid_subtb`` at the recipes' sizes, over 20 steps;
``serve``      samples per second of a bitseq ``Scheduler`` (64 lanes)
               serving 287 samples in four requests (``chip_smoke.py``'s
               serve requests; ``decode_step`` eager each block).

Prints one JSON line per round with the checkout and the card's name and
power limit.  ``--profile FILE`` then runs ``cProfile`` over 20 more eager
steps of each recipe and writes the 40 functions of most own time, and
the 40 of most cumulative time, to FILE.  To compare two commits on one card, unpack the other into a
directory that ``.gitignore`` lists (``git archive``) and run the
checkouts in turn, one process each, in the order A, B, B, A.  Needs a
CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

CALLS = 2000
STEPS = 20


def _per_call_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def wrapper_calls(ops, device) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device)

    q, k, v = randn(16, 8, 8), randn(16, 16, 8, 8), randn(16, 16, 8, 8)
    kv_valid = torch.arange(1, 17, dtype=torch.int32, device=device)
    logits = randn(16, 15, 3840).requires_grad_(True)
    actions = torch.randint(0, 3840, (16, 15), generator=g).to(device)
    mask = torch.ones(16, 15, 3840, dtype=torch.bool, device=device)
    valid = torch.ones(16, 15, dtype=torch.bool, device=device)
    phi = randn(16, 30).requires_grad_(True)
    length = torch.randint(1, 30, (16,), generator=g).to(device)

    def attn():
        with torch.no_grad():
            ops.decode_attention(q, k, v, kv_valid)

    def traj():
        ops.traj_logprob(logits, actions, mask, valid)[0].sum().backward()

    def subtb():
        ops.subtb_loss(phi, length, 0.9).sum().backward()

    return {"decode_attention": _per_call_us(attn, CALLS),
            "traj_logprob_fwd_bwd": _per_call_us(traj, CALLS),
            "subtb_loss_fwd_bwd": _per_call_us(subtb, CALLS)}


def train_steps(recipes, TrainLoop, name: str, device,
                profiler=None) -> float:
    rec = recipes.get_train(name)
    env = rec.make_env()
    cfg = rec.make_config(env, rec.num_envs, rec.iterations)
    pol = rec.make_policy(env, seed=1, device=device, requires_grad=True)
    loop = TrainLoop(env, env.init(device), pol, cfg)
    state = loop.init(seed=5)
    loop.step(state)
    torch.cuda.synchronize()
    if profiler is not None:
        profiler.enable()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loop.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if profiler is not None:
        profiler.disable()
    return wall / STEPS * 1e3


def serve(SampleRequest, Scheduler, device) -> float:
    sched = Scheduler(num_lanes=64, init_seed=0, device=device)
    sched.submit(SampleRequest(env="bitseq", num_samples=64, seed=1000))
    sched.run()
    reqs = [SampleRequest(env="bitseq", num_samples=16, seed=1),
            SampleRequest(env="bitseq", num_samples=64, seed=2,
                          logit_temp=0.8),
            SampleRequest(env="bitseq", num_samples=7, seed=3,
                          reward_beta=2.0),
            SampleRequest(env="bitseq", num_samples=200, seed=4,
                          logit_temp=0.8, reward_beta=2.0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    return sum(r.num_samples for r in reqs) / (time.perf_counter() - t0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, required=True)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--profile", type=Path, default=None)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("eager_wrappers_ab: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.checkout.resolve() / "src"))
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.kernels import build, ops
    from repro_torch.serve import SampleRequest, Scheduler

    build.build()
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for rep in range(opts.reps):
        row = {"checkout": str(opts.checkout), "rep": rep,
               "call_us": wrapper_calls(ops, device),
               "step_ms": {n: train_steps(recipes, TrainLoop, n, device)
                           for n in ("bitseq_tb", "hypergrid_subtb")},
               "serve_samples_per_s": serve(SampleRequest, Scheduler,
                                            device),
               "card": card}
        print(json.dumps(row), flush=True)
    if opts.profile is not None:
        import cProfile
        import io
        import pstats
        prof = cProfile.Profile()
        for n in ("bitseq_tb", "hypergrid_subtb"):
            train_steps(recipes, TrainLoop, n, device, prof)
        out = io.StringIO()
        for key in ("tottime", "cumulative"):
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(40)
        opts.profile.write_text(f"{opts.checkout} {card}\n{out.getvalue()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
