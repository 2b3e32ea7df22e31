#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA GPU.  It
imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing one JSON line:

1. device  - ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build   - compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel  - each kernel against its plain PyTorch version on the card, at
             the serving shapes, with its time, the plain version's time and
             the least time the card could take (``bound``);
4. serve   - the bitseq serving path at full width (n=120, k=8, a 3-layer
             dim-64 policy from a seeded generator, 64 lanes, 4 requests)
             through the scheduler; every sample is held against the port's
             ``forward_rollout`` and the kernel's launches are counted;

then a ``kernels`` line, the card's ``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; so does a machine without CUDA, or a directory without the
repository's ``src/repro_torch``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: kernel vs plain version: fp32 with another reduction order
TOL = 1e-4
#: lanes whose two best Gumbel scores lie this close may pick either
TIE_GAP = 1e-5
SERVE_LANES = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_us(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events (L2 warm, as on the serving loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def device_rows(prof):
    """(kernel name, device us, count) of the device-side events of a
    ``torch.profiler`` run, largest first (host ops, which carry their
    kernels' time too, are left out so nothing counts twice)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[1])


def profiled_device_us(fn, iters: int = 50) -> float:
    """Mean device time of the CUDA kernels ``fn`` launches, summed from
    ``torch.profiler`` (fails if the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(t for _, t, _ in device_rows(prof))
    if not total > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total / iters


# -- phase 3: decode_step against its plain version ---------------------------

def random_step_inputs(B, L, C, D, H, F, A, seed, device):
    """Operands of one fused step, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device)

    w = {"ln1_scale": 1 + rn(L, D, scale=0.1), "ln1_bias": rn(L, D, scale=0.1),
         "q_w": rn(L, D, D, scale=D ** -0.5), "q_b": rn(L, D, scale=0.1),
         "kv_w": rn(L, D, 2 * D, scale=D ** -0.5),
         "kv_b": rn(L, 2 * D, scale=0.1),
         "proj_w": rn(L, D, D, scale=D ** -0.5),
         "proj_b": rn(L, D, scale=0.1),
         "ln2_scale": 1 + rn(L, D, scale=0.1),
         "ln2_bias": rn(L, D, scale=0.1),
         "ff1_w": rn(L, D, F, scale=D ** -0.5), "ff1_b": rn(L, F, scale=0.1),
         "ff2_w": rn(L, F, D, scale=F ** -0.5), "ff2_b": rn(L, D, scale=0.1),
         "ln_f_scale": 1 + rn(D, scale=0.1), "ln_f_bias": rn(D, scale=0.1),
         "q0": rn(D, scale=0.02)}
    lengths = torch.randint(0, C - 1, (B,), generator=g, dtype=torch.int32)
    u = torch.rand((B, A), generator=g).clamp_(1e-12, 1 - 1e-7)
    mask = torch.rand((B, A), generator=g) < 0.5
    mask[:, 0] |= ~mask.any(-1)
    return dict(
        w=w, x_new=rn(B, D, scale=0.5),
        k=rn(L, B, C, H, D // H), v=rn(L, B, C, H, D // H),
        lengths=lengths.to(device),
        slot=lengths.clamp(1, C - 1).to(device),
        gumbel=(-torch.log(-torch.log(u))).to(device),
        mask=mask.to(device),
        w_out=rn(D, A, scale=D ** -0.5), b_out=rn(A, scale=0.1),
        temp=(0.5 + torch.rand(B, generator=g)).to(device))


def step_bound(inp) -> dict:
    """Least time for one fused step on these inputs: each input byte read
    once (the cache only at the slots the masks attend), each output byte
    written once, and the fp32 operations, against the data-sheet rates."""
    w, lengths = inp["w"], inp["lengths"]
    L, B, C, H, hd = inp["k"].shape
    D, A, F = H * hd, inp["mask"].shape[1], w["ff1_w"].shape[-1]
    live = int(torch.clamp(lengths + 1, max=C).sum())
    weights = sum(t.numel() for t in w.values()) + D * A + A
    read = 4 * (weights + B * D + 2 * L * live * D + B * A + 3 * B) + B * A
    written = 4 * (2 * L * B * D + B * D + 2 * B)
    gemv = 2 * B * (L * (D * 2 * D + 2 * D * D + 2 * D * F) + D * A)
    attn = 4 * L * live * D
    flops = gemv + attn
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return {"bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + written, "flops": flops}


def check_decode_step(B, L, C, D, H, F, A, seed, device) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_decode_step

    inp = random_step_inputs(B, L, C, D, H, F, A, seed, device)
    w = inp["w"]
    args = (inp["lengths"], inp["slot"], inp["gumbel"], inp["mask"],
            inp["w_out"], inp["b_out"], inp["temp"])

    def plain():
        return ref_decode_step(w, inp["x_new"], inp["k"].view(L, B, C, D),
                               inp["v"].view(L, B, C, D), *args,
                               num_heads=H)

    cache = {"k": inp["k"].clone(), "v": inp["v"].clone()}

    def kernel():
        return ops.decode_step(w, inp["x_new"], cache, *args, num_heads=H)

    a_r, lp_r, y_r, k_r, v_r = plain()
    a_k, lp_k, y_k, _ = kernel()
    torch.cuda.synchronize()
    # lanes whose two best scores are within TIE_GAP may pick either action
    logp = torch.log_softmax(torch.where(
        inp["mask"], (y_r @ inp["w_out"] + inp["b_out"])
        * inp["temp"][:, None], torch.finfo(torch.float32).min), -1)
    top2 = torch.topk(logp + inp["gumbel"], 2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < TIE_GAP
    same = a_r == a_k
    mismatched = int((~same & ~tie).sum())
    err = {"log_pf": float((lp_r - lp_k)[same].abs().max()) if same.any()
           else 0.0,
           "y": float((y_r - y_k).abs().max()),
           "cache": max(float((k_r - cache["k"].view(L, B, C, D)).abs().max()),
                        float((v_r - cache["v"].view(L, B, C, D)).abs().max()))}
    # the kernel's own device time, and the wrapper's (host checks and
    # launch included) between CUDA events
    kernel_us = profiled_device_us(kernel)
    wrapper_us = cuda_time_us(kernel)
    plain_us = cuda_time_us(plain, iters=20, warmup=3)
    row = {"B": B, "L": L, "C": C, "D": D, "H": H, "F": F, "A": A,
           "actions_equal": int(same.sum()), "near_ties": int(tie.sum()),
           "mismatched_actions": mismatched, "max_abs_err": err,
           "kernel_us": kernel_us, "wrapper_us": wrapper_us,
           "plain_us": plain_us, **step_bound(inp)}
    emit("kernel", name="decode_step", **row)
    if mismatched or max(err.values()) > TOL or not all(
            math.isfinite(v) for v in err.values()):
        raise AssertionError(f"decode_step disagrees with its plain version "
                             f"at B={B}: {mismatched} actions, errors {err}")
    return row


# -- phase 4: the serving path -------------------------------------------------

def serve_phase(device) -> dict:
    """Serve four requests through the scheduler at full width; hold every
    sample against ``forward_rollout``; return the main path's kernel
    launches."""
    import numpy as np

    from repro_torch.core.rollout import forward_rollout
    from repro_torch.kernels import ops
    from repro_torch.serve import SampleRequest, Scheduler

    smi = nvidia_smi()
    t0 = time.perf_counter()
    sched = Scheduler(num_lanes=SERVE_LANES, init_seed=0, device=device)
    # warm-up: builds the engine (n=120, k=8; 3-layer dim-64 policy) and
    # runs its step once, so the timed run below is steady state
    sched.submit(SampleRequest(env="bitseq", num_samples=SERVE_LANES,
                               seed=1000))
    sched.run()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [SampleRequest(env="bitseq", num_samples=16, seed=1),
            SampleRequest(env="bitseq", num_samples=64, seed=2,
                          logit_temp=0.8),
            SampleRequest(env="bitseq", num_samples=7, seed=3,
                          reward_beta=2.0),
            SampleRequest(env="bitseq", num_samples=200, seed=4,
                          logit_temp=0.8, reward_beta=2.0)]
    engine = sched.engine_for(reqs[0])
    steps0, blocks0 = engine.steps_run, engine.blocks_run

    ops.decode_step.launches = 0
    t0 = time.perf_counter()
    rids = [sched.submit(r) for r in reqs]
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_step": ops.decode_step.launches}

    env, params, policy = engine.env.env, engine.inner_params, engine.policy
    n_samples = 0
    for req, rid in zip(reqs, rids):
        res = results[rid]
        samples = np.asarray(res.samples)
        ref = forward_rollout(req.seed, env, params, policy, req.num_samples,
                              logit_temp=req.logit_temp)
        ref_tokens = ref.obs[-1].cpu().numpy()
        ref_log_r = (torch.tensor(req.reward_beta, dtype=torch.float32,
                                  device=device)
                     * ref.log_reward).cpu().numpy()
        log_r = np.asarray(res.log_rewards, np.float32)
        if samples.shape != (req.num_samples, env.L):
            raise AssertionError(f"request {rid}: samples of shape "
                                 f"{samples.shape}")
        if not np.array_equal(samples, ref_tokens):
            raise AssertionError(
                f"request {rid}: {int((samples != ref_tokens).any(1).sum())}"
                f" of {req.num_samples} samples differ from forward_rollout")
        if (samples == env.empty).any() or \
                not (np.asarray(res.steps) == env.L).all():
            raise AssertionError(f"request {rid}: a sample is not terminal")
        if not np.isfinite(log_r).all() or \
                np.abs(log_r - ref_log_r).max() > 1e-6:
            raise AssertionError(f"request {rid}: log_r {log_r[:4]} vs "
                                 f"forward_rollout {ref_log_r[:4]}")
        n_samples += req.num_samples
    if launches["decode_step"] == 0:
        raise AssertionError("the serving path never launched decode_step")
    lat = np.asarray([results[r].latency_s for r in rids])
    emit("serve", nvidia_smi=smi, env="bitseq n=120 k=8 (A=3840)",
         policy="decode arch, 3 layers, dim 64, 8 heads, F 256",
         lanes=SERVE_LANES, requests=len(reqs), samples=n_samples,
         wall_s=wall, samples_per_s=n_samples / wall,
         requests_per_s=len(reqs) / wall,
         latency_p50_s=float(np.percentile(lat, 50)),
         latency_p99_s=float(np.percentile(lat, 99)),
         lane_steps=engine.steps_run - steps0,
         blocks=engine.blocks_run - blocks0,
         launches=launches, setup_s=setup_s,
         matches_forward_rollout=True)
    profile_serve(sched, device)
    return launches


def profile_serve(sched, device) -> None:
    """Where a serve run's time goes: one request mix timed plain, then
    under ``torch.profiler`` (device time by kernel; the device's idle
    share of the plain run's wall time), then under ``cProfile`` (host
    functions by own time; cProfile slows Python calls, so read shares,
    not times)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import SampleRequest

    def mix(first_seed):
        for seed in (first_seed, first_seed + 1):
            sched.submit(SampleRequest(env="bitseq", num_samples=128,
                                       seed=seed))
        sched.run()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix(11)
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mix(21)
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    host = cProfile.Profile()
    host.runcall(mix, 31)
    stats = pstats.Stats(host).stats
    total = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    emit("serve_profile", samples=256, wall_us=wall_us, device_busy_us=busy,
         device_idle_share=1 - busy / wall_us,
         device_top=[{"name": k[:70], "device_us": t, "calls": c}
                     for k, t, c in rows[:10]],
         host_top=[{"function": f"{Path(f).name}:{ln}:{fn}",
                    "own_share": v[2] / total, "calls": v[1]}
                   for (f, ln, fn), v in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build()
    build.library()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(Path(path).relative_to(ROOT)),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln])

    rows = [check_decode_step(B, 3, 16, 64, 8, 256, 3840, seed=B,
                              device=device)
            for B in (1, 7, SERVE_LANES, 128, 256)]
    rows.append(check_decode_step(5, 2, 9, 48, 6, 80, 203, seed=99,
                                  device=device))
    main_row = next(r for r in rows if r["B"] == SERVE_LANES)

    launches = serve_phase(device)

    print(json.dumps({"kernels": [{
        "name": "decode_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_step.cu",
        "replaces": "src/repro/kernels/decode_attention.py:239",
        "launches": launches["decode_step"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in rows),
        "ms": main_row["kernel_us"] / 1e3,
        "plain_ms": main_row["plain_us"] / 1e3,
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"], "library_ms": None}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
