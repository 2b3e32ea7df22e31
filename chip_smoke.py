#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names a checkout of the parent commit: its decode_step,
decode_attention, traj_logprob backward and subtb_loss kernels are built
beside this tree's and timed on the same inputs (each of those rows prints
``parent_kernel_us``).

Run from a checkout of the repository on a machine with a CUDA GPU.  It
imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing one JSON line:

1. device  - ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build   - compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one ``nvcc`` per source, in parallel), and times one
             ``nvcc -shared`` call over all sources beside it; ptxas's
             report with the function named on each line, and the
             functions that spill;
3. kernel  - each kernel (decode_step, decode_attention, traj_logprob and
             subtb_loss forward and backward, flash_attention,
             rwkv6_scan) against its plain PyTorch version on the card,
             at the main paths' shapes (the sequence recipes' included:
             decode_attention at (16, 9 / 61, 8, 8) with ragged lengths,
             traj_logprob at (16, 8, 4), (16, 5, 22), (128, 61, 21), the
             fused step at their eval rollouts') and at odd ones, with its
             device time, the plain version's, the least time the card
             could take (``bound``) and, where one PyTorch call computes the
             same function, that call's (``library_us``); each flash row
             names the route it took (``ops.flash_route``: the
             tensor-core kernel for bf16 at D % 16 == 0, else SIMT), and
             each scan row its route (``ops.scan_route``: the chunk
             kernels for bf16 at T >= 64, else the step recurrence); a
             chunk row also holds and times the recurrence kernel on the
             same inputs, and one row draws decays far below the JAX
             chunk form's 1e-30 clamp; subtb rows also take potentials at
             an offset of 1e3 (where JAX's expanded prefix form cancels),
             lambda = 1 and two tiles of the block layout, each backward
             held row by row; the decode_step, decode_attention,
             traj_logprob backward and subtb rows print the launch floor
             measured in the run (``floor_us``, a one-element in-place
             add);
   decode_step_lanes - the serving batch against the same lanes reversed
             and a 5-lane subset, and a repeated call: bitwise equal;
4. serve   - the bitseq serving path at full width (n=120, k=8, a 3-layer
             dim-64 policy from a seeded generator, 64 lanes, 4 requests)
             through the scheduler; every sample is held against the port's
             ``forward_rollout`` and the kernels' launches are counted;
   serve_profile - the serving loop's device idle share, device and host
             tops;
5. train   - ``bitseq_tb`` training at full width (16 envs) for 50
             iterations through ``repro_torch.run.run_recipe`` (evals off:
             seqs_evals times them), the launches of every kernel counted
             (45 decode_attention, 2 traj_logprob forward and 1 backward
             per iteration);
   train_hold - one iteration on the card and on the CPU (plain versions)
             from the same parameters and noise: actions, loss, gradients;
   train_profile - one iteration's device idle share, device and host tops;
   trained_fused_step - after the optimizer steps of the two phases
             before it, the fused step's weight cache (filled before them)
             holds the live weights, and the fused step equals its plain
             chain;
6. hypergrid_train - ``hypergrid_subtb`` at full size (4x8^4, 16 envs, MLP
             2x256) for 50 iterations through ``run_recipe``, with its
             evals at iterations 0 and 49; launches read at every
             iteration (1 subtb_loss forward and 1 backward each, 2
             traj_logprob forwards at the eval iterations, nothing else);
   hypergrid_hold - one iteration on the card and on the CPU, as
             train_hold;
   hypergrid_profile - one iteration's device idle share and tops;
   hypergrid_converge - SubTB on the 2x8 grid for 2,500 iterations
             (``tests/test_training.py:19-43``): empirical TV of 4,000
             samples under 0.12, with the exact-DP TV beside it; and the
             exact DP of the paper's 20^4 grid on the card against the
             CPU's;
7. seqs_train - ``tfbind8_tb`` and ``qm9_tb`` (50 iterations) and
             ``amp_tb`` (10) at full width through ``run_recipe``, evals
             off; it/s, samples/s and the launches of every iteration held
             exactly (decode_attention / traj_logprob forward / backward:
             tfbind8 16 / 2 / 1, qm9 0 / 2 / 1, amp 183 / 0 / 0);
   seqs_hold - one iteration of each on the card and on the CPU, as
             train_hold;
   seqs_profile - that iteration's device idle share and tops;
   seqs_kv_valid - an AMP rollout's cached queries attend length + 1
             slots (BOS included), ragged across rows;
   seqs_evals - the eval suite of bitseq_tb, tfbind8_tb, qm9_tb and
             amp_tb once at full width (and AMP's top-100 reward and
             diversity): metrics, seconds, launches; every metric finite,
             the correlations in [-1, 1];
   path_shapes - every shape at which the phases the kernels line counts
             (serve, train, hypergrid_train, seqs_train, seqs_evals)
             launched decode_step, decode_attention or traj_logprob has a
             row of phase 3, held against the plain version;
8. lm_decode - ``repro_torch.launch.lm_decode.serve`` with Hymba-1.5B at
             full width and depth (32 layers, d_model 1600, bf16, random
             weights from a seeded generator on the card): batch 8, 32
             prompt tokens, 32 generated; tokens/s, steps/s, exactly 32
             rwkv6_scan launches per step (recurrence route) and no
             flash;
   lm_prefill - ``launch.steps.make_prefill_step`` over 2 x 4,096 tokens:
             tokens/s, device time by kernel, finite log-probs, exactly 32
             flash_attention (all on the tensor-core route) and 32
             rwkv6_scan launches (all on the chunk route);
   scan_hold - the same pass with each layer's scan operands captured:
             on Hymba's own decays the chunk route holds to the step
             recurrence, layer by layer; the smallest in-chunk decay
             product each layer saw; the log-prob difference between a
             pass on each route (reported);
   lm_profile - one full-width decode step's idle share and tops;
   lm_hold - a 2-layer full-width fp32 Hymba (window 32) on the card
             (kernels) against the CPU (plain versions): a 512-token
             scoring pass and 40 decode steps, 1e-3, greedy tokens equal;

then a ``kernels`` line, the card's ``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; so does a machine without CUDA, or a directory without the
repository's ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: kernel vs plain version: fp32 with another reduction order
TOL = 1e-4
#: traj_logprob backward vs plain, entry by entry (``bwd_excess``)
BWD_RTOL = 1e-4
BWD_ATOL = 1e-8
#: lanes whose two best Gumbel scores lie this close may pick either
TIE_GAP = 1e-5
#: profiler windows tried before a kernel's device time counts as missing
#: (or before a window that lost some of a kernel's records is used)
PROFILE_TRIES = 3
SERVE_LANES = 64
TRAIN_ITERS = 50
#: bitseq_tb at full width: 3 layers x 15 steps of cached queries, and
#: traj_logprob forward for P_F and P_B, backward for P_F, per iteration
TRAIN_LAUNCHES_PER_ITER = {"decode_attention": 45, "traj_logprob_fwd": 2,
                           "traj_logprob_bwd": 1, "decode_step": 0,
                           "subtb_loss_fwd": 0, "subtb_loss_bwd": 0,
                           "flash_attention": 0, "rwkv6_scan": 0}
#: hypergrid_subtb at full size: iterations, and evals at 0 and 49
HYPERGRID_ITERS = 50
HYPERGRID_EVAL_EVERY = 49
#: hypergrid_subtb per iteration: the SubTB loss forward and backward; the
#: stop-action path takes no traj_logprob, the LogZBoundsEval two
HYPERGRID_LAUNCHES_PER_ITER = {"decode_attention": 0, "traj_logprob_fwd": 0,
                               "traj_logprob_bwd": 0, "decode_step": 0,
                               "subtb_loss_fwd": 1, "subtb_loss_bwd": 1,
                               "flash_attention": 0, "rwkv6_scan": 0}
HYPERGRID_EVAL_LAUNCHES = {"traj_logprob_fwd": 2}
#: the sequence-design recipes at full width: iterations of seqs_train,
#: and each iteration's launches (read from the code: a cached exploring
#: rollout queries decode_attention once per layer and step; a loss
#: without a stop action takes two traj_logprob forwards, P_F and P_B, and
#: one backward, P_F's; AMP's stop-action loss takes none)
SEQ_ITERS = {"tfbind8_tb": 50, "qm9_tb": 50, "amp_tb": 10}
SEQ_LAUNCHES_PER_ITER = {
    # 2 layers x 8 steps
    "tfbind8_tb": {"decode_attention": 16, "traj_logprob_fwd": 2,
                   "traj_logprob_bwd": 1},
    # the pooled encoder over 5 blocks: no cache
    "qm9_tb": {"decode_attention": 0, "traj_logprob_fwd": 2,
               "traj_logprob_bwd": 1},
    # 3 layers x 61 steps (60 symbols and the stop)
    "amp_tb": {"decode_attention": 183, "traj_logprob_fwd": 0,
               "traj_logprob_bwd": 0}}
SEQ_RECIPES = {"tfbind8_tb": "TFBind8 (length 8, vocab 4, A=4, A_b=1)",
               "qm9_tb": "QM9 (5 blocks of 11, A=22, A_b=2)",
               "amp_tb": "AMP (max_len 60, vocab 20 + stop, A=21, A_b=2)"}
SEQ_POLICIES = {"tfbind8_tb": "decode arch, 2 layers, dim 64, 8 heads",
                "qm9_tb": "pooled arch, 2 layers, dim 64, 8 heads",
                "amp_tb": "decode arch, 3 layers, dim 64, 8 heads, "
                          "log Z from 150"}
#: tests/test_training.py:19-43 on the card
CONVERGE_ITERS = 2500
CONVERGE_TV = 0.12
#: H100 SXM data sheet: dense bf16 tensor-core peak (the bound of a kernel
#: whose products take bf16 operands)
BF16_FLOP_PER_S = 989e12
#: kernel vs plain version with bf16 outputs, entry by entry: both round
#: the same fp32 value, and may land one bf16 ulp apart, at most 2^-7 of
#: the entry; entries near 0 are allowed 1e-3 of the output's rms
BF16_RTOL = 2.0 ** -7
BF16_ATOL_RMS = 1e-3
#: Hymba-1.5B (src/repro/configs/hymba_1_5b.py): 32 layers, one flash and
#: one scan launch per layer and pass
HYMBA_LAYERS = 32
DECODE_BATCH, DECODE_PROMPT, DECODE_GEN = 8, 32, 32
PREFILL_BATCH, PREFILL_LEN = 2, 4096
#: lm_hold: 2 full-width layers in fp32, a 32-slot window
HOLD_LAYERS, HOLD_TOKENS, HOLD_WINDOW, HOLD_STEPS = 2, 512, 32, 40
HOLD_TOL = 1e-3
#: in the device-kernel name of both flash routes (``ops.flash_route``:
#: ``flash_attention_kernel``, ``flash_attention_wgmma_kernel``), so the
#: profiler's flash time sums every kernel either route launches
FLASH_MATCH = "flash_attention"
#: in the device-kernel name of every kernel of both scan routes
#: (``ops.scan_route``: ``rwkv6_scan_kernel``; ``rwkv6_chunk_state_kernel``,
#: ``rwkv6_chunk_carry_kernel``, ``rwkv6_chunk_out_kernel``), and of each
#: route's own
SCAN_MATCH = "rwkv6_"
SCAN_ROUTE_MATCH = {"recurrence": "rwkv6_scan_kernel",
                    "chunk": "rwkv6_chunk_"}


def wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name; each counts its own
    launches."""
    from repro_torch.kernels import ops
    return {"decode_step": ops.decode_step,
            "decode_attention": ops.decode_attention,
            "traj_logprob_fwd": ops.traj_logprob,
            "traj_logprob_bwd": ops.traj_logprob_backward,
            "subtb_loss_fwd": ops.subtb_loss,
            "subtb_loss_bwd": ops.subtb_loss_backward,
            "flash_attention": ops.flash_attention,
            "rwkv6_scan": ops.rwkv6_scan}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0
    from repro_torch.kernels import ops
    ops.flash_attention.route_launches = {r: 0 for r in
                                          ops.flash_attention.route_launches}
    ops.rwkv6_scan.route_launches = {r: 0 for r in
                                     ops.rwkv6_scan.route_launches}


def flash_routes() -> dict:
    """Launches of each flash route since the last reset."""
    from repro_torch.kernels import ops
    return dict(ops.flash_attention.route_launches)


def scan_routes() -> dict:
    """Launches of each scan route since the last reset."""
    from repro_torch.kernels import ops
    return dict(ops.rwkv6_scan.route_launches)


@contextlib.contextmanager
def forced_scan_route(route: str):
    """``ops.scan_route`` held at ``route`` for the block (here only: the
    package reads no setting that picks a route)."""
    from repro_torch.kernels import ops
    real = ops.scan_route
    ops.scan_route = lambda dtype, steps: route
    try:
        yield
    finally:
        ops.scan_route = real


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


#: the shapes the main path handed each kernel, recorded while
#: ``recording_path_shapes`` is on; each needs a row of its check
PATH_SHAPES = {"decode_step": set(), "decode_attention": set(),
               "traj_logprob": set()}


@contextlib.contextmanager
def recording_path_shapes():
    """Record the shape of every call the port's modules make, on a CUDA
    tensor, to the decode_step, decode_attention and traj_logprob wrappers
    (the backward's logits are the forward's).  The modules hold each
    wrapper under an imported name; that name is swapped for a recorder
    that calls the wrapper itself, so launch counts are untouched.  The
    checks call ``ops`` and are not recorded."""
    from repro_torch.core import objectives, policies
    from repro_torch.kernels import ops
    from repro_torch.nn import transformer

    def step_shape(w, x_new, cache, *args, **kwargs):
        L, B, C, H, hd = cache["k"].shape
        return x_new, (B, L, C, H * hd, H, w["ff1_w"].shape[-1],
                       args[4].shape[1])

    sites = [(policies, "decode_step", ops.decode_step, step_shape),
             (transformer, "decode_attention", ops.decode_attention,
              lambda q, k, *a, **kw: (q, tuple(k.shape))),
             (objectives, "traj_logprob", ops.traj_logprob,
              lambda logits, *a, **kw: (logits, tuple(logits.shape)))]

    def recorder(name, wrapper, shape):
        def call(*args, **kwargs):
            t, key = shape(*args, **kwargs)
            if t.is_cuda:
                PATH_SHAPES[name].add(tuple(int(d) for d in key))
            return wrapper(*args, **kwargs)
        return call

    for module, name, wrapper, shape in sites:
        setattr(module, name, recorder(name, wrapper, shape))
    try:
        yield
    finally:
        for module, name, wrapper, _ in sites:
            setattr(module, name, wrapper)


def check_path_shapes(rows, attn, traj) -> None:
    """Every shape the main path launched a kernel at has a row of that
    kernel's check (held against its plain version); fails otherwise."""
    checked = {"decode_step": {tuple(r[k] for k in "BLCDHFA") for r in rows},
               "decode_attention": {(r["B"], r["S"], r["H"], r["hd"])
                                    for r in attn},
               "traj_logprob": {(f["B"], f["T"], f["A"]) for f, _ in traj}}
    unchecked = {k: sorted(v - checked[k]) for k, v in PATH_SHAPES.items()}
    emit("path_shapes", launched={k: sorted(v)
                                  for k, v in PATH_SHAPES.items()},
         unchecked=unchecked)
    if not all(PATH_SHAPES.values()) or any(unchecked.values()):
        raise AssertionError(f"kernel shapes on the main path with no "
                             f"check row: {unchecked}")


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


def profiled_rows(fn, iters: int = 50, match: str = "") -> list:
    """``device_rows`` of ``iters`` calls of ``fn`` whose name holds
    ``match``.  Now and then the profiler hands back no kernel records for
    a short window (seen once for a 2.5 us kernel), or only some of them
    (seen as a library call read at a third of the launch floor).  A
    window in which some kernel was not recorded a whole number of times
    per call is profiled again; after PROFILE_TRIES windows the one with
    the most records counts (fails if none recorded any)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in device_rows(prof) if match in r[0]]
        if rows and all(n % iters == 0 for _, _, n in rows):
            return rows
        if sum(n for _, _, n in rows) > sum(n for _, _, n in best):
            best = rows
    if not best:
        raise AssertionError(f"torch.profiler recorded no device time in "
                             f"{PROFILE_TRIES} tries")
    return best


def profiled_device_us(fn, iters: int = 50, match: str = "") -> float:
    """Mean device time of the CUDA kernels ``fn`` launches whose name
    holds ``match``, summed from ``torch.profiler``."""
    return sum(t for _, t, _ in profiled_rows(fn, iters, match)) / iters


def profiled_kernels(fn, iters: int = 50) -> dict:
    """``fn``'s device time per call from ``torch.profiler`` and every
    device kernel it saw, ``{name: launches per call}``."""
    rows = profiled_rows(fn, iters)
    return {"us": sum(t for _, t, _ in rows) / iters,
            "kernels": {name: n / iters for name, _, n in rows}}


def sdpa_backend(kernels) -> str:
    """The ``scaled_dot_product_attention`` backend named by the device
    kernels it launched."""
    names = " ".join(kernels).lower()
    for key, backend in (("fmha", "efficient"), ("flash", "flash"),
                         ("cudnn", "cudnn")):
        if key in names:
            return backend
    return "math"


def launch_floor_us(device) -> float:
    """The launch floor: profiled device time of a one-element in-place
    ``torch.add_`` (the least a kernel launch costs on the card)."""
    x = torch.zeros(1, device=device)
    return profiled_device_us(lambda: x.add_(1.0))


def named_ptxas(log: str) -> list:
    """ptxas's report with the function named on every line: each
    "Compiling entry function" line as it is, and every register, spill and
    shared-memory line after it prefixed with that function."""
    out, fn = [], "?"
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)'?", ln)
        if m:
            fn = m.group(1)
        if "Compiling entry function" in ln:
            out.append(ln.strip())
        elif "registers" in ln or "spill" in ln or "smem" in ln:
            out.append(f"{fn}: {ln.strip()}")
    return out


def spilling(lines: list) -> list:
    """Functions whose ptxas line reports spill stores or loads."""
    return sorted({ln.split(":")[0] for ln in lines
                   if re.search(r"[1-9]\d* bytes spill", ln)})


#: the kernels' sources rebuilt from a checkout of the parent commit
#: (``--parent``) to time them beside this tree's in the same run
PARENT_SOURCES = ("decode_step.cu", "decode_attention.cu", "traj_logprob.cu",
                  "subtb_loss.cu")


class ParentSubtbArgs(ctypes.Structure):
    """Mirror of the parent's ``SubtbArgs`` (its subtb_loss.cu): this
    tree's without ``table``, the scratch weight table it filled past
    ``repro_subtb_smem_states()`` states."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("phi", "length", "g", "loss", "dphi", "table")]
                + [(n, ctypes.c_longlong) for n in ("phi_sb", "phi_st")]
                + [("lam", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("batch", "states", "device")])


def parent_library(parent: Path):
    """Build a parent checkout's kernels (``PARENT_SOURCES``) into a library
    of their own (its own namespace); returns it and its named ptxas
    lines."""
    from repro_torch.kernels import build
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "libparent.so"
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(path),
             *(str(csrc / name) for name in PARENT_SOURCES)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"parent build failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        lib = ctypes.CDLL(str(path))
    lib.repro_decode_step.argtypes = [ctypes.POINTER(build.DecodeStepArgs),
                                      ctypes.c_void_p]
    lib.repro_decode_step.restype = ctypes.c_int
    lib.repro_decode_attention.argtypes = [
        ctypes.POINTER(build.DecodeAttentionArgs), ctypes.c_void_p]
    lib.repro_decode_attention.restype = ctypes.c_int
    lib.repro_traj_logprob_bwd.argtypes = [
        ctypes.POINTER(build.TrajLogprobArgs), ctypes.c_void_p]
    lib.repro_traj_logprob_bwd.restype = ctypes.c_int
    for fn in (lib.repro_subtb_fwd, lib.repro_subtb_bwd):
        fn.argtypes = [ctypes.POINTER(ParentSubtbArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_subtb_smem_states.argtypes = []
    lib.repro_subtb_smem_states.restype = ctypes.c_int
    return lib, named_ptxas(proc.stdout + proc.stderr)


def parent_call(fn, args, device):
    """A call of a parent kernel on the current stream (no launch
    counted)."""
    def call():
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device)
                 .cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent kernel launch failed: CUDA error "
                               f"{err}")
    return call


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


def step_args(inp, cache, outs, device):
    """``DecodeStepArgs`` of one call on these operands (as the wrapper
    builds them), for a parent kernel."""
    from repro_torch.kernels import build
    L, B, C, H, hd = cache["k"].shape
    ptrs = {"x_new": inp["x_new"], "k_cache": cache["k"],
            "v_cache": cache["v"], "lengths": inp["lengths"],
            "slot": inp["slot"], "logit_temp": inp["temp"],
            "gumbel": inp["gumbel"], "mask": inp["mask"],
            "w_out": inp["w_out"], "b_out": inp["b_out"], "action": outs[0],
            "log_pf": outs[1], "y": outs[2], **inp["w"]}
    return build.DecodeStepArgs(
        **{k: ptrs[k].data_ptr() for k in build.DECODE_STEP_PTRS},
        num_layers=L, batch=B, capacity=C, dim=H * hd, num_heads=H,
        ff_dim=inp["w"]["ff1_w"].shape[-1], num_actions=inp["mask"].shape[1],
        device=device.index or 0)


def check_decode_step(B, L, C, D, H, F, A, seed, device, floor_us,
                      parent=None) -> dict:
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
    plain_us = profiled_device_us(plain, iters=10)
    plain_wall_us = cuda_time_us(plain, iters=20, warmup=3)
    parent_us = None
    if parent is not None:
        pcache = {"k": inp["k"].clone(), "v": inp["v"].clone()}
        pouts = (torch.empty(B, dtype=torch.int32, device=device),
                 torch.empty(B, device=device), torch.empty(B, D, device=device))
        parent_us = profiled_device_us(parent_call(
            parent.repro_decode_step, step_args(inp, pcache, pouts, device),
            device))
    row = {"B": B, "L": L, "C": C, "D": D, "H": H, "F": F, "A": A,
           "actions_equal": int(same.sum()), "near_ties": int(tie.sum()),
           "mismatched_actions": mismatched, "max_abs_err": err,
           "kernel_us": kernel_us, "floor_us": floor_us,
           "parent_kernel_us": parent_us, "wrapper_us": wrapper_us,
           "plain_us": plain_us, "plain_wall_us": plain_wall_us,
           **step_bound(inp)}
    emit("kernel", name="decode_step", **row)
    if mismatched or max(err.values()) > TOL or not all(
            math.isfinite(v) for v in err.values()):
        raise AssertionError(f"decode_step disagrees with its plain version "
                             f"at B={B}: {mismatched} actions, errors {err}")
    return row


def check_decode_step_lanes(device) -> dict:
    """A lane's outputs do not depend on its neighbours or its place in a
    tile: the serving batch (64 lanes) against the same lanes reversed and
    a 5-lane subset, and two calls on the same inputs; actions, log_pf, y
    and the appended cache bitwise equal."""
    from repro_torch.kernels import ops

    B, L, C, D, H, F, A = SERVE_LANES, 3, 16, 64, 8, 256, 3840
    inp = random_step_inputs(B, L, C, D, H, F, A, seed=7, device=device)

    def run(idx):
        cache = {"k": inp["k"][:, idx].clone(), "v": inp["v"][:, idx].clone()}
        a, lp, y, _ = ops.decode_step(
            inp["w"], inp["x_new"][idx], cache, inp["lengths"][idx],
            inp["slot"][idx], inp["gumbel"][idx], inp["mask"][idx],
            inp["w_out"], inp["b_out"], inp["temp"][idx], num_heads=H)
        return a, lp, y, cache["k"], cache["v"]

    every = torch.arange(B, device=device)
    full = run(every)

    def same(idx):
        out = run(idx)
        torch.cuda.synchronize()
        return (all(torch.equal(o, f[idx]) for o, f in zip(out[:3], full))
                and all(torch.equal(o, f[:, idx])
                        for o, f in zip(out[3:], full[3:])))

    checks = {"reversed": same(every.flip(0)),
              "subset_5": same(torch.tensor([3, 17, 40, 41, 63],
                                            device=device)),
              "repeat": same(every)}
    emit("decode_step_lanes", B=B, bitwise_equal=checks)
    if not all(checks.values()):
        raise AssertionError(f"decode_step lanes depend on their tile: "
                             f"{checks}")
    return checks


def timings(kernel, plain, library, match: str = "",
            plain_iters: int = 20) -> dict:
    """Device time per call (``torch.profiler``, the kernels' own time) of
    the kernel, its plain version and the library call, so the three
    compare like for like; and each one's time per call between CUDA
    events over back-to-back calls (``*_wall_us``: host dispatch included,
    which for a chain of small ops is most of it).  ``match`` keeps the
    kernel's own device time apart from the small torch kernels its
    wrapper launches (operand checks)."""
    out = {"kernel_us": profiled_device_us(kernel, match=match),
           "wrapper_us": cuda_time_us(kernel),
           "plain_us": profiled_device_us(plain, iters=plain_iters),
           "plain_wall_us": cuda_time_us(plain, iters=5 * plain_iters // 2,
                                         warmup=max(1, plain_iters // 4)),
           "library_us": None, "library_wall_us": None}
    if library is not None:
        out["library_us"] = profiled_device_us(library)
        out["library_wall_us"] = cuda_time_us(library)
    return out


def bound(nbytes: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    """The larger of the byte time and the operation time at the peak of
    the operands' type (fp32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return {"bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# -- phase 3: decode_attention against its plain version ------------------------

def check_decode_attention(B, S, H, hd, kv_valid, seed, device, floor_us,
                           parent=None) -> dict:
    """The kernel and its plain version on the same inputs; the library
    yardstick is ``F.scaled_dot_product_attention`` with a boolean mask over
    the rows that attend at least one slot (it gives NaN on an empty row)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_decode_attention

    g = torch.Generator().manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g).to(device)
    q, k, v = rn(B, H, hd), rn(B, S, H, hd), rn(B, S, H, hd)
    kv = torch.as_tensor(kv_valid, dtype=torch.int32).to(device)

    def plain():
        return ref_decode_attention(q, k, v, kv)

    def kernel():
        return ops.decode_attention(q, k, v, kv)

    want, got = plain(), kernel()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    empty_exact = bool(torch.all(got[kv <= 0] == 0))
    rows = (kv >= 1).nonzero()[:, 0]
    lq, lk, lv = q[rows][:, :, None], k[rows].transpose(1, 2), \
        v[rows].transpose(1, 2)
    lmask = (torch.arange(S, device=device)[None, :]
             < kv[rows][:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)

    library_err = float((library()[:, :, 0] - want[rows]).abs().max())
    # the yardstick read three times more, each with the kernels the
    # profiler matched and the SDPA backend they name
    readings = [profiled_kernels(library) for _ in range(3)]
    for r in readings:
        r["backend"] = sdpa_backend(r["kernels"])
    live = int(torch.clamp(kv, 0, S).sum())
    nbytes = 4 * (2 * B * H * hd + 2 * live * H * hd + B)
    flops = live * H * (4 * hd + 3) + B * H * hd
    parent_us = None
    if parent is not None:
        from repro_torch.kernels import build
        pout = torch.empty_like(q)
        parent_us = profiled_device_us(parent_call(
            parent.repro_decode_attention, build.DecodeAttentionArgs(
                q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                kv_valid=kv.data_ptr(), out=pout.data_ptr(), batch=B,
                slots=S, num_heads=H, head_dim=hd,
                device=device.index or 0), device))
    row = {"B": B, "S": S, "H": H, "hd": hd, "kv_valid": list(kv_valid),
           "max_abs_err": err, "empty_rows_exact_zero": empty_exact,
           **timings(kernel, plain, library), "floor_us": floor_us,
           "parent_kernel_us": parent_us,
           "library_call": "F.scaled_dot_product_attention(bool mask), "
                           "rows with kv_valid >= 1",
           "library_max_abs_err": library_err,
           "library_readings": readings, **bound(nbytes, flops)}
    emit("kernel", name="decode_attention", **row)
    if not (err <= TOL) or not empty_exact:
        raise AssertionError(f"decode_attention disagrees with its plain "
                             f"version at {(B, S, H, hd)}: error {err}, "
                             f"empty rows exact zero {empty_exact}")
    return row


# -- phase 3: traj_logprob forward and backward against their plain versions -----

def traj_inputs(B, T, A, seed, device):
    """Time-major (T+1, B, A) logits and mask handed over as the (B, T, A)
    transposed views the training loss passes; the taken action is legal,
    and each row has a valid prefix."""
    g = torch.Generator().manual_seed(seed)
    logits = 3 * torch.randn(T + 1, B, A, generator=g)
    mask = torch.rand(T + 1, B, A, generator=g) < 0.6
    actions = torch.randint(0, A, (T, B), generator=g)
    mask[torch.arange(T)[:, None], torch.arange(B)[None, :], actions] = True
    valid = torch.arange(T)[:, None] < torch.randint(1, T + 1, (1, B),
                                                     generator=g)
    return (logits.to(device)[:-1].transpose(0, 1), actions.to(device).T,
            mask.to(device)[:-1].transpose(0, 1), valid.to(device).T,
            torch.randn(B, generator=g).to(device),
            torch.randn(T, B, generator=g).to(device).T)


def bwd_excess(d_k, d_p, actions, valid, g_total, g_step):
    """The backward's largest error over its allowance, entry by entry.
    Most entries are ``coeff * softmax`` terms of ~1e-5, so each is held to
    BWD_RTOL of its own size (plus BWD_ATOL), not only the largest error
    to TOL.  The taken action's entry is ``coeff * (1 - p)``, which cancels
    as p nears 1; it is held to BWD_RTOL of ``|coeff|``."""
    coeff = ((g_total[:, None] + g_step) * valid).abs()
    scale = d_p.abs().scatter(-1, actions.long()[..., None],
                              coeff[..., None])
    return ((d_k - d_p).abs() / (BWD_ATOL + BWD_RTOL * scale)).max()


def check_traj_logprob(B, T, A, seed, device, floor_us, parent=None):
    """Forward and backward kernels against their plain versions; returns
    the two rows.  The forward's library yardstick is one
    ``F.cross_entropy(reduction="none")`` over logits masked beforehand
    (timed alone); the backward has none.  With ``parent`` the parent's
    backward kernel is timed on the same inputs (``parent_kernel_us``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (ref_traj_logprob,
                                         ref_traj_logprob_backward)

    logits, actions, mask, valid, g_total, g_step = traj_inputs(
        B, T, A, seed, device)
    nbt, nbta = B * T, B * T * A
    shape = {"B": B, "T": T, "A": A}

    def fwd_kernel():
        with torch.no_grad():
            return ops.traj_logprob(logits, actions, mask, valid)

    def fwd_plain():
        return ref_traj_logprob(logits, actions, mask, valid)

    (t_k, s_k), (t_p, s_p) = fwd_kernel(), fwd_plain()
    again = fwd_kernel()
    torch.cuda.synchronize()
    err = max(float((t_k - t_p).abs().max()), float((s_k - s_p).abs().max()))
    bitwise = bool(torch.equal(again[0], t_k) and torch.equal(again[1], s_k))
    premasked = torch.where(mask, logits, torch.finfo(torch.float32).min
                            ).reshape(nbt, A)
    flat_actions = actions.reshape(nbt)

    def library():
        return F.cross_entropy(premasked, flat_actions, reduction="none")

    library_err = float((-library().reshape(B, T) - s_p)[valid].abs().max())
    fwd = {**shape, "max_abs_err": err, "repeat_bitwise_equal": bitwise,
           **timings(fwd_kernel, fwd_plain, library,
                     match="traj_logprob_fwd"),
           "library_call": "F.cross_entropy(reduction='none') on logits "
                           "masked beforehand, timed alone",
           "library_max_abs_err": library_err,
           **bound(4 * nbta + nbta + 8 * nbt + nbt + 4 * (B + nbt),
                   5 * nbta)}
    emit("kernel", name="traj_logprob_fwd", **fwd)

    def bwd_kernel():
        return ops.traj_logprob_backward(logits, actions, mask, valid,
                                         g_total, g_step)

    def bwd_plain():
        return ref_traj_logprob_backward(logits, actions, mask, valid,
                                         g_total, g_step)

    d_k, d_p = bwd_kernel(), bwd_plain()
    torch.cuda.synchronize()
    berr = float((d_k - d_p).abs().max())
    b_excess = float(bwd_excess(d_k, d_p, actions, valid, g_total, g_step))
    parent_us = None
    if parent is not None:
        pout = torch.empty(B, T, A, device=device)
        parent_us = profiled_device_us(parent_call(
            parent.repro_traj_logprob_bwd, ops._traj_args(
                logits, actions, mask, valid, g_total=g_total, g_step=g_step,
                dlogits=pout), device), match="traj_logprob")
    bwd = {**shape, "max_abs_err": berr,
           "max_err_over_allowed": b_excess,
           "allowed": f"{BWD_ATOL} + {BWD_RTOL} * |plain| (the taken "
                      f"action's entry: * |coeff|)",
           **timings(bwd_kernel, bwd_plain, None, match="traj_logprob"),
           "floor_us": floor_us, "parent_kernel_us": parent_us,
           **bound(4 * nbta + nbta + 8 * nbt + nbt + 4 * (B + nbt)
                   + 4 * nbta, 9 * nbta)}
    emit("kernel", name="traj_logprob_bwd", **bwd)
    if not (err <= TOL and berr <= TOL and b_excess <= 1 and bitwise):
        raise AssertionError(f"traj_logprob disagrees with its plain "
                             f"version at {(B, T, A)}: forward {err}, "
                             f"backward {berr} ({b_excess} of the "
                             f"element-wise allowance), repeat bitwise "
                             f"{bitwise}")
    return fwd, bwd


# -- phase 3: subtb_loss forward and backward against their plain versions --------

def subtb_inputs(B, T1, seed, device, kind="normal", offset=0.0):
    """Time-major potentials (T+1, B), N(0, 1) or a random walk along T,
    plus ``offset`` (the level log Z sets), handed over as the (B, T+1)
    view the loss passes; lengths (int64, as the loss gives them) starting
    T, 0, 1 (a single row gets T); a cotangent."""
    g = torch.Generator().manual_seed(seed)
    phi_tm = torch.randn(T1, B, generator=g)
    if kind == "walk":
        phi_tm = phi_tm.cumsum(0)
    phi_tm = phi_tm + offset
    length = torch.randint(0, T1, (B,), generator=g)
    length[:3] = torch.tensor([T1 - 1, 0, 1])[:B]
    return (phi_tm.to(device).T, length.to(device),
            torch.randn(B, generator=g).to(device))


def row_err_over_scale(got, want) -> float:
    """The largest error over the largest entry, trajectory by trajectory
    (a short trajectory's large entries would hide a long one's errors),
    the worst of them; a row whose gradient is all 0 counts as inf unless
    it is exactly 0."""
    scale = want.abs().amax(1)
    err = (got - want).abs().amax(1)
    live = scale > 0
    dead_exact = bool(torch.all(err[~live] == 0))
    worst = float((err[live] / scale[live]).max()) if live.any() else 0.0
    return worst if dead_exact else math.inf


def parent_subtb_us(parent, fn, phi, length, lam, device, **ptrs) -> float:
    """Device time of one of the parent's SubTB kernels on these inputs,
    with the scratch table it takes past its shared-memory size."""
    B, T1 = phi.shape
    table = None
    if T1 > parent.repro_subtb_smem_states():
        table = torch.empty(T1, device=device)
    length32 = length.to(torch.int32).contiguous()
    args = ParentSubtbArgs(
        phi=phi.data_ptr(), length=length32.data_ptr(),
        **{k: v.data_ptr() for k, v in ptrs.items()},
        table=None if table is None else table.data_ptr(),
        phi_sb=phi.stride(0), phi_st=phi.stride(1), lam=lam, batch=B,
        states=T1, device=device.index or 0)
    return profiled_device_us(parent_call(fn, args, device), match="subtb")


def check_subtb(B, T1, lam, seed, device, floor_us, kind="normal",
                offset=0.0, parent=None):
    """Forward and backward kernels against their plain versions at one
    shape; returns the two rows.  No single PyTorch call computes the
    SubTB form, so there is no library yardstick.  The kernel's device
    time is its own kernel's (``subtb``); the wrapper's operand checks
    (an ``aminmax`` of the lengths and their int32 copy) are in
    ``wrapper_us``.  The bound counts what the O(T) scan needs: phi read
    once, the lengths, the loss or dphi written once; ~20 FLOP an
    on-trajectory state forward, ~40 backward.  With ``parent`` the
    parent's kernels are timed on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_subtb, ref_subtb_backward

    phi, length, g = subtb_inputs(B, T1, seed, device, kind, offset)
    n = length.long().cpu()
    on_traj = int((n + 1).sum())
    shape = {"B": B, "T1": T1, "lam": lam, "phi": kind, "offset": offset,
             "lengths": n.tolist()[:8]}

    def fwd_kernel():
        with torch.no_grad():
            return ops.subtb_loss(phi, length, lam)

    def fwd_plain():
        return ref_subtb(phi, length, lam)

    got, want = fwd_kernel(), fwd_plain()
    again = fwd_kernel()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    bitwise = bool(torch.equal(again, got))
    zero_exact = bool(torch.all(got[length == 0] == 0))
    parent_fwd = parent_bwd = None
    if parent is not None:
        parent_fwd = parent_subtb_us(
            parent, parent.repro_subtb_fwd, phi, length, lam, device,
            loss=torch.empty(B, device=device))
    fwd = {**shape, "max_abs_err": err, "max_rel_err": rel,
           "repeat_bitwise_equal": bitwise, "empty_rows_exact_zero":
           zero_exact, **timings(fwd_kernel, fwd_plain, None, match="subtb"),
           "floor_us": floor_us, "parent_kernel_us": parent_fwd,
           **bound(4 * on_traj + 8 * B + 4 * B, 20 * on_traj)}
    emit("kernel", name="subtb_loss_fwd", **fwd)

    def bwd_kernel():
        return ops.subtb_loss_backward(phi, length, g, lam)

    def bwd_plain():
        return ref_subtb_backward(phi, length, lam, g)

    d_k, d_p = bwd_kernel(), bwd_plain()
    d_again = bwd_kernel()
    torch.cuda.synchronize()
    berr = float((d_k - d_p).abs().max())
    scale = float(d_p.abs().max())
    b_bitwise = bool(torch.equal(d_again, d_k))
    b_zero_exact = bool(torch.all(d_k[length == 0] == 0))
    if parent is not None:
        parent_bwd = parent_subtb_us(
            parent, parent.repro_subtb_bwd, phi, length, lam, device, g=g,
            dphi=torch.empty(B, T1, device=device))
    bwd = {**shape, "max_abs_err": berr,
           "max_err_over_scale": berr / scale if scale else berr,
           "max_row_err_over_scale": row_err_over_scale(d_k, d_p),
           "repeat_bitwise_equal": b_bitwise,
           "empty_rows_exact_zero": b_zero_exact,
           **timings(bwd_kernel, bwd_plain, None, match="subtb"),
           "floor_us": floor_us, "parent_kernel_us": parent_bwd,
           **bound(4 * on_traj + 8 * B + 4 * B + 4 * B * T1, 40 * on_traj)}
    emit("kernel", name="subtb_loss_bwd", **bwd)
    if not (rel <= TOL and bitwise and zero_exact and b_bitwise
            and b_zero_exact and bwd["max_err_over_scale"] <= TOL
            and bwd["max_row_err_over_scale"] <= TOL):
        raise AssertionError(f"subtb_loss disagrees with its plain version "
                             f"at {(B, T1, lam, kind, offset)}: forward rel "
                             f"{rel}, backward {bwd['max_err_over_scale']} "
                             f"of its scale ({bwd['max_row_err_over_scale']}"
                             f" row by row), repeat bitwise {bitwise} / "
                             f"{b_bitwise}, n = 0 exact zero {zero_exact} / "
                             f"{b_zero_exact}")
    return fwd, bwd


# -- phase 3: flash_attention and rwkv6_scan against their plain versions ---------

def _held(got, want, bf16: bool) -> dict:
    """Hold ``got`` to ``want`` entry by entry, in fp32: |got - want| <=
    rtol |want| + atol rms(want), (rtol, atol) = (BF16_RTOL, BF16_ATOL_RMS)
    for bf16 outputs and (TOL, TOL) for fp32.  ``excess`` is the largest
    ratio of an entry's error to what it is allowed (the check: <= 1); the
    median |want| and rms(want) stand beside it to show the margin."""
    got, want = got.float(), want.float()
    rtol, atol = (BF16_RTOL, BF16_ATOL_RMS) if bf16 else (TOL, TOL)
    diff = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    allowed = rtol * want.abs() + atol * rms
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / allowed)
    return {"max_abs_err": float(diff.max()), "excess": float(ratio.max()),
            "want_median_abs": float(want.abs().median()), "want_rms": rms,
            "tol": f"{rtol:g} |want| + {atol:g} rms(want), entry by entry"}


def check_flash_attention(B, Sq, Skv, H, KVH, D, *, causal, window,
                          bf16, seed, device, q_offset=0,
                          kv_len=None) -> dict:
    """The kernel, its plain version (dense, fp32 scores) and, as the
    library yardstick, ``F.scaled_dot_product_attention`` with the same
    boolean mask on (B, H, S, D) operands (kv heads repeated beforehand)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_mask, ref_flash_attention

    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.randn(shape, generator=g).to(device, dt) for shape in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)

    def plain():
        return ref_flash_attention(q, k, v, **kw)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    want = plain()
    routes = flash_routes()
    got = kernel()
    torch.cuda.synchronize()
    route = [r for r, n in flash_routes().items() if n != routes[r]]
    held = _held(got, want, bf16)
    mask = attention_mask(Sq, Skv, device=device, **kw)
    G = H // KVH
    lq = q.transpose(1, 2).contiguous()
    lk, lv = (x.repeat_interleave(G, 2).transpose(1, 2).contiguous()
              for x in (k, v))

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)

    library_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
    pairs = int(mask.sum()) * B * H             # attended (query, key) pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    row = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KVH": KVH, "D": D,
           "dtype": str(dt), "causal": causal, "window": window,
           "q_offset": q_offset, "kv_len": kv_len, "route": route, **held,
           **timings(kernel, plain, library, match=FLASH_MATCH),
           "library_call": "F.scaled_dot_product_attention(bool mask), kv "
                           "heads repeated",
           "library_max_abs_err": library_err, "attended_pairs": pairs,
           **bound(nbytes, 4 * D * pairs,
                   BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)}
    emit("kernel", name="flash_attention", **row)
    if not held["excess"] <= 1 or route != [ops.flash_route(dt, D)]:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {(B, Sq, Skv, H, KVH, D)}: {held}, "
                             f"route {route}")
    return row


def scan_inputs(B, T, H, Dk, Dv, *, bonus, state, bf16, decay, seed,
                device):
    """r, k, v ~ N(0, 1) in the working dtype; w fp32 by ``decay``: "mild"
    in [0.35, 0.95] as the JAX tests draw it, "strong" log-uniform in
    [1e-8, 0.3] (0.3^64 < 1e-30: a chunk's product far below the JAX chunk
    form's clamp); u ~ 0.1 N(0, 1); a state ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    rn = lambda *shape: torch.randn(shape, generator=g)
    r, k, v = (rn(*shape).to(device, dt) for shape in (
        (B, T, H, Dk), (B, T, H, Dk), (B, T, H, Dv)))
    if decay == "mild":
        w = 0.35 + 0.6 * torch.sigmoid(rn(B, T, H, Dk))
    else:
        lo, hi = math.log(1e-8), math.log(0.3)
        w = torch.exp(lo + (hi - lo) * torch.rand(B, T, H, Dk, generator=g))
    u = (0.1 * rn(H, Dk)).to(device) if bonus else None
    s0 = rn(B, H, Dk, Dv).to(device) if state else None
    return r, k, v, w.to(device), u, s0


def check_rwkv6_scan(B, T, H, Dk, Dv, *, bonus, state, bf16, seed,
                     device, decay="mild") -> dict:
    """The kernel of the route ``ops.scan_route`` picks against its plain
    version (the step recurrence the CPU branch runs; one torch op chain
    per step, so it is timed over a few calls when T is long), on
    :func:`scan_inputs`.  The output is held as a bf16 or fp32 output, the
    fp32 state as fp32.  A row on the chunk route also runs the recurrence
    kernel on the same inputs (the route forced here), holds it too, and
    times it beside the chunk kernels (and each of their three passes); a
    repeat call must be bitwise equal.
    No library call computes this recurrence."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rwkv6

    dt = torch.bfloat16 if bf16 else torch.float32
    r, k, v, w, u, s0 = scan_inputs(B, T, H, Dk, Dv, bonus=bonus, state=state,
                                    bf16=bf16, decay=decay, seed=seed,
                                    device=device)

    def plain():
        return ref_rwkv6(r, k, v, w, u, s0)

    def kernel():
        return ops.rwkv6_scan(r, k, v, w, u, s0)

    want_o, want_s = plain()
    routes = scan_routes()
    got_o, got_s = kernel()
    torch.cuda.synchronize()
    route = [n for n, c in scan_routes().items() if c != routes[n]]
    held = {"o": _held(got_o, want_o, bf16),
            "state": _held(got_s, want_s, False)}
    again_o, again_s = kernel()
    bitwise = torch.equal(again_o, got_o) and torch.equal(again_s, got_s)
    nbytes = (r.element_size() * (2 * r.numel() + 2 * v.numel())
              + 4 * w.numel() + 4 * B * H * Dk * Dv * (2 if state else 1))
    flops = 4 * Dk * Dv * B * T * H
    row = {"B": B, "T": T, "H": H, "Dk": Dk, "Dv": Dv, "dtype": str(dt),
           "bonus": bonus, "state": state, "decay": decay, "route": route,
           "max_abs_err": {n: h["max_abs_err"] for n, h in held.items()},
           "held": held, "repeat_bitwise_equal": bitwise,
           **timings(kernel, plain, None,
                     match=SCAN_ROUTE_MATCH[ops.scan_route(dt, T)],
                     plain_iters=2 if T > 256 else 20),
           **bound(nbytes, flops)}
    if route == ["chunk"]:
        with forced_scan_route("recurrence"):
            rec_o, rec_s = kernel()
            torch.cuda.synchronize()
            row["recurrence_held"] = {"o": _held(rec_o, want_o, bf16),
                                      "state": _held(rec_s, want_s, False)}
            row["recurrence_us"] = profiled_device_us(
                kernel, match=SCAN_ROUTE_MATCH["recurrence"])
        # the chunk route's three launches, each alone
        row["chunk_pass_us"] = {
            name: profiled_device_us(kernel, match=f"rwkv6_chunk_{name}_")
            for name in ("state", "carry", "out")}
    emit("kernel", name="rwkv6_scan", **row)
    excess = [h["excess"] for h in held.values()] + [
        h["excess"] for h in row.get("recurrence_held", {}).values()]
    if not all(e <= 1 for e in excess) or not bitwise \
            or route != [ops.scan_route(dt, T)]:
        raise AssertionError(f"rwkv6_scan disagrees with its plain version "
                             f"at {(B, T, H, Dk, Dv)} ({decay} decay): "
                             f"{held}, route {route}, repeat bitwise equal "
                             f"{bitwise}, recurrence route "
                             f"{row.get('recurrence_held')}")
    return row


# -- phase 4: the serving path -------------------------------------------------

def serve_phase(device) -> dict:
    """Serve four requests through the scheduler at full width; hold every
    sample against ``forward_rollout``; return the main path's kernel
    launches."""
    import numpy as np

    from repro_torch.core.rollout import forward_rollout
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

    reset_launches()
    t0 = time.perf_counter()
    rids = [sched.submit(r) for r in reqs]
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

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


# -- phase 5: bitseq_tb training --------------------------------------------------

def train_phase(device) -> dict:
    """``bitseq_tb`` at full width for TRAIN_ITERS iterations through the
    user's entry point, with every kernel's launches counted."""
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    # evals off: run_recipe evaluates at iteration 0, which would count
    # the evals' launches and time here (seqs_evals times them)
    out = run_recipe("bitseq_tb", iterations=TRAIN_ITERS, seed=0,
                     device=device, eval_every=0, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    hist = out["history"]
    want = {k: n * TRAIN_ITERS for k, n in TRAIN_LAUNCHES_PER_ITER.items()}
    if launches != want:
        raise AssertionError(f"training launched {launches}, expected "
                             f"{want}")
    if len(hist) != TRAIN_ITERS or not all(
            math.isfinite(r[k]) for r in hist
            for k in ("loss", "log_z", "mean_log_reward")):
        raise AssertionError(f"training rows not finite: {hist[-3:]}")

    steady = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    first, last = hist[0], hist[-1]
    emit("train", nvidia_smi=smi, recipe="bitseq_tb",
         env="bitseq n=120 k=8 (L=15, A=3840, A_b=15)",
         policy="decode arch, 3 layers, dim 64, 8 heads, F 256",
         num_envs=16, iterations=TRAIN_ITERS, wall_s=wall,
         iterations_per_s=TRAIN_ITERS / wall,
         steady_iterations_per_s=steady,
         samples_per_s=16 * TRAIN_ITERS / wall,
         steady_samples_per_s=16 * steady,
         first={k: first[k] for k in ("it", "loss", "log_z",
                                      "mean_log_reward")},
         last={k: last[k] for k in ("it", "loss", "log_z",
                                    "mean_log_reward")},
         launches=launches,
         launches_per_iteration={k: v / TRAIN_ITERS
                                 for k, v in launches.items()})
    return launches


def _to_cpu(batch):
    import dataclasses
    return type(batch)(**{f.name: getattr(batch, f.name).cpu()
                          for f in dataclasses.fields(batch)})


def hold_iteration(phase: str, recipe_name: str, device, env=None):
    """One iteration of a recipe on the card (kernels) and on the host's
    CPU (plain versions) from the same parameters and noise.  Actions: the
    card's rollout against the CPU's, except a row whose first difference
    sits at a step where the top two scores lie within TIE_GAP (counted).
    Loss and gradients: both devices teacher-force the card's batch, so a
    tie cannot move them; loss to 1e-5 relative, each gradient to 1e-4 of
    its own tensor's largest entry (no floor).  Returns the card's policy,
    loop and state."""
    from repro_torch import recipes
    from repro_torch.algo import TrainLoop
    from repro_torch.core.trainer import current_eps
    from repro_torch.core.types import (hash_step_noise, masked_logprobs,
                                        train_seed)

    recipe = recipes.get_train(recipe_name)
    cpu = torch.device("cpu")
    env = recipe.make_env(**(env or {}))
    cfg = recipe.make_config(env, 16, recipe.iterations)
    pol_g = recipe.make_policy(env, seed=1, device=device,
                               requires_grad=True)
    pol_c = recipe.make_policy(env, seed=1, device=cpu, requires_grad=True)
    pol_c.load_params({k: v.detach().cpu()
                       for k, v in pol_g.params.flat().items()})
    loop_g = TrainLoop(env, env.init(device), pol_g, cfg)
    loop_c = TrainLoop(env, env.init(cpu), pol_c, cfg)
    st_g, st_c = loop_g.init(seed=5), loop_c.init(seed=5)
    batch_g = loop_g.sample(st_g)
    batch_c = loop_c.sample(st_c)
    a_g, a_c = batch_g.actions.cpu(), batch_c.actions
    T, B = a_c.shape
    differ = (a_g != a_c)
    ties, mismatched = 0, 0
    if differ.any():
        with torch.no_grad():
            logits = pol_c.apply(batch_c.obs.reshape(
                (T + 1) * B, -1))["logits"].reshape(T + 1, B, -1)
        for b in range(B):
            rows = differ[:, b].nonzero()
            if not len(rows):
                continue
            t = int(rows[0])
            noise = hash_step_noise(
                torch.tensor([train_seed(5, 0)]), torch.tensor([b]),
                torch.tensor([t]), env.action_dim)
            mask = batch_c.fwd_mask[t, b] | batch_c.done[t, b]
            if float(noise.explore_u[0]) < current_eps(cfg, 0):
                score = torch.where(mask, 0.0, float("-inf")) \
                    + noise.gumbel_u[0]
            else:
                score = masked_logprobs(logits[t, b], mask) + noise.gumbel[0]
            top2 = torch.topk(score, 2).values
            if float(top2[0] - top2[1]) < TIE_GAP:
                ties += 1
            else:
                mismatched += 1
    loss_g = float(loop_g.loss_and_grads(batch_g))
    loss_c = float(loop_c.loss_and_grads(_to_cpu(batch_g)))
    grads_c = {k: p.grad for k, p in pol_c.params.flat().items()}
    grad_err = {}
    for k, p in pol_g.params.flat().items():
        scale = float(grads_c[k].abs().max())
        diff = float((p.grad.cpu() - grads_c[k]).abs().max())
        grad_err[k] = diff / scale if scale else (0.0 if diff == 0
                                                  else math.inf)
    worst = max(grad_err, key=grad_err.get)
    rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
    emit(phase, recipe=recipe_name, steps=T, envs=B,
         actions_equal=int((~differ).sum()),
         rows_differing=int(differ.any(0).sum()), near_tie_rows=ties,
         mismatched_rows=mismatched, loss_cuda=loss_g, loss_cpu=loss_c,
         loss_rel_err=rel, grad_max_err_over_scale=grad_err[worst],
         grad_worst_param=worst)
    if mismatched or not rel <= 1e-5 or not grad_err[worst] <= 1e-4:
        raise AssertionError(
            f"{phase}: {mismatched} rows differ off a tie, loss rel "
            f"error {rel}, gradient error {grad_err[worst]} ({worst})")
    return pol_g, loop_g, st_g


def train_hold_phase(device):
    """One bitseq_tb iteration on the card against the CPU's.  No optimizer
    step has run yet, so the fused step's weight cache is filled here, for
    ``trained_fused_step`` to check after the steps of train_profile."""
    pol_g, loop_g, st_g = hold_iteration("train_hold", "bitseq_tb", device,
                                         env={"seed": 0})
    before = {k: v.clone() for k, v in
              pol_g.kernel_weights()["stacked"].items()}
    return loop_g, st_g, before


def train_profile(loop, state, phase: str = "train_profile") -> None:
    """Where one training iteration's time goes (:func:`profile_step`)."""
    profile_step(phase, lambda: loop.step(state))


def profile_step(phase: str, step, **fields) -> None:
    """Where one call of ``step`` (a training iteration, a decode step)
    spends its time: timed plain, then under ``torch.profiler`` (device
    time by kernel; the device's idle share of the plain call's wall time),
    then under ``cProfile`` (host functions by own time; read shares, not
    times)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def one():
        step()
        torch.cuda.synchronize()

    one()                                   # warm: allocator, cuBLAS
    t0 = time.perf_counter()
    one()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    host = cProfile.Profile()
    host.runcall(one)
    stats = pstats.Stats(host).stats
    total = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    emit(phase, **fields, iterations=1, wall_us=wall_us,
         device_busy_us=busy, device_idle_share=1 - busy / wall_us,
         device_kernels=sum(r[2] for r in rows),
         device_top=[{"name": k[:70], "device_us": t, "calls": c}
                     for k, t, c in rows[:10]],
         host_top=[{"function": f"{Path(f).name}:{ln}:{fn}",
                    "own_share": v[2] / total, "calls": v[1]}
                   for (f, ln, fn), v in top])


# -- phase 6: hypergrid training -----------------------------------------------

def hypergrid_train_phase(device) -> dict:
    """``hypergrid_subtb`` at full size (4x8^4, 16 envs, MLP 2x256) for
    HYPERGRID_ITERS iterations through ``run_recipe``, with the recipe's
    evals at iterations 0 and 49.  Launches are read at every iteration:
    one SubTB forward and one backward each, two traj_logprob forwards
    (the log Z bounds) at the eval iterations only, no other kernel."""
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    reset_launches()
    last = read_launches()
    per_it = []

    def log(line):
        if line.startswith("it "):
            now = read_launches()
            per_it.append({k: now[k] - last[k] for k in now})
            last.update(now)

    t0 = time.perf_counter()
    out = run_recipe("hypergrid_subtb", iterations=HYPERGRID_ITERS, seed=0,
                     device=device, eval_every=HYPERGRID_EVAL_EVERY,
                     log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    hist, rows = out["history"], out["rows"]
    eval_its = list(range(0, HYPERGRID_ITERS, HYPERGRID_EVAL_EVERY))
    for it, got in enumerate(per_it):
        want = dict(HYPERGRID_LAUNCHES_PER_ITER)
        if it in eval_its:
            want.update(HYPERGRID_EVAL_LAUNCHES)
        if got != want:
            raise AssertionError(f"hypergrid iteration {it} launched {got}, "
                                 f"expected {want}")
    if len(per_it) != HYPERGRID_ITERS or [r["step"] for r in rows] \
            != eval_its:
        raise AssertionError(f"hypergrid: {len(per_it)} iterations, eval "
                             f"rows at {[r['step'] for r in rows]}")
    if not all(math.isfinite(r[k]) for r in hist
               for k in ("loss", "log_z", "mean_log_reward")) or not all(
            math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"hypergrid rows not finite: {hist[-2:]}, "
                             f"{rows}")
    # iterations 1..48 run no eval
    steady = (HYPERGRID_ITERS - 2) / (hist[-2]["wall_s"] - hist[0]["wall_s"])
    last_it_s = hist[-1]["wall_s"] - hist[-2]["wall_s"]
    emit("hypergrid_train", nvidia_smi=smi, recipe="hypergrid_subtb",
         env="hypergrid 4x8^4 (4,096 states, T+1 = 30, A = 5)",
         policy="MLP 2x256, A logits + flow head", num_envs=16,
         iterations=HYPERGRID_ITERS, wall_s=wall,
         iterations_per_s=HYPERGRID_ITERS / wall,
         steady_iterations_per_s=steady,
         steady_samples_per_s=16 * steady,
         eval_seconds=last_it_s - 1 / steady,
         first={k: hist[0][k] for k in ("loss", "log_z", "mean_log_reward")},
         last={k: hist[-1][k] for k in ("loss", "log_z",
                                        "mean_log_reward")},
         evals=rows, launches=launches,
         launches_per_iteration={k: v / HYPERGRID_ITERS
                                 for k, v in launches.items()})
    return launches


def hypergrid_converge(device) -> None:
    """``tests/test_training.py:19-43`` on the card: SubTB on the 2x8 grid
    with an MLP (64, 64), epsilon 0.05 annealed over 1,250 iterations, 2,500
    iterations; the empirical TV of 4,000 samples must be under 0.12.  The
    exact-DP TV stands beside it.  Then one exact DP on the paper's 20^4
    grid (160,000 states) on the card, held to the CPU's."""
    from repro_torch.algo import TrainLoop
    from repro_torch.core.policies import MLPPolicy
    from repro_torch.core.rollout import forward_rollout
    from repro_torch.core.trainer import GFNConfig
    from repro_torch.evals import ExactDistributionEval, make_hypergrid_dp
    from repro_torch.metrics.distributions import (empirical_distribution,
                                                   total_variation)
    from repro_torch.recipes.hypergrid import (hypergrid_env,
                                               hypergrid_policy,
                                               terminal_index_fn)

    smi = nvidia_smi()
    env = hypergrid_env(dim=2, side=8)
    params = env.init(device)
    policy = MLPPolicy(env.obs_dim, env.action_dim, env.backward_action_dim,
                       hidden=(64, 64), seed=1, device=device,
                       requires_grad=True)
    cfg = GFNConfig(objective="subtb", num_envs=16, lr=1e-3, log_z_lr=1e-1,
                    stop_action=env.dim, exploration_eps=0.05,
                    exploration_anneal_steps=CONVERGE_ITERS // 2)
    reset_launches()
    t0 = time.perf_counter()
    _, hist = TrainLoop(env, params, policy, cfg).run(
        1, CONVERGE_ITERS, callback=lambda it, st, m, b: float(m["loss"])
        if it % 500 == 0 or it == CONVERGE_ITERS - 1 else None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    true = env.true_distribution(params)
    batch = forward_rollout(2, env, params, policy, 4000)
    emp = empirical_distribution(terminal_index_fn(env)(batch),
                                 env.num_terminal_states)
    tv = float(total_variation(emp, true))
    exact = {k: float(v) for k, v in
             ExactDistributionEval(env, params, policy)(0).items()}

    env20 = hypergrid_env(dim=4, side=20)
    pol_g = hypergrid_policy(env20, seed=3, device=device)
    pol_c = hypergrid_policy(env20, seed=3, device=torch.device("cpu"))
    pol_c.load_params({k: v.detach().cpu()
                       for k, v in pol_g.params.flat().items()})
    t0 = time.perf_counter()
    dp_g = make_hypergrid_dp(env20, env20.init(device), pol_g)()
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    dp_c = make_hypergrid_dp(env20, env20.init("cpu"), pol_c)()
    dp_err = float((dp_g.cpu() - dp_c).abs().max())
    dp_tv = float(total_variation(dp_g.cpu(), dp_c))
    emit("hypergrid_converge", nvidia_smi=smi, objective="subtb",
         env="hypergrid 2x8 (64 states)", policy="MLP 64x64",
         iterations=CONVERGE_ITERS, train_seconds=train_s,
         iterations_per_s=CONVERGE_ITERS / train_s,
         losses=[h for h in hist if h is not None],
         sample_tv_4000=tv, bar=CONVERGE_TV, exact_tv=exact["exact_tv"],
         exact_jsd=exact["exact_jsd"],
         launches={k: v for k, v in launches.items() if v},
         dp_20x4={"states": env20.num_terminal_states,
                  "cuda_seconds": dp_s, "max_abs_err_vs_cpu": dp_err,
                  "tv_vs_cpu": dp_tv, "sum": float(dp_g.sum())})
    want = {"subtb_loss_fwd": CONVERGE_ITERS,
            "subtb_loss_bwd": CONVERGE_ITERS}
    if not tv < CONVERGE_TV or {k: v for k, v in launches.items() if v} \
            != want or not dp_err <= 1e-6 or not dp_tv <= 1e-5:
        raise AssertionError(
            f"hypergrid_converge: TV {tv} (bar {CONVERGE_TV}), launches "
            f"{launches}, 20^4 DP error {dp_err}, TV to the CPU {dp_tv}")


def trained_fused_step(loop, state, before: dict, device) -> None:
    """After the optimizer steps of train_hold and train_profile (torch's
    Adam on the card), the fused step's weight cache, filled before them,
    must hold the live weights, and the fused step (the serving kernel)
    must equal the plain ``apply_cached`` + ``sample_masked`` chain on the
    same noise, one step from the initial state."""
    from repro_torch import recipes
    from repro_torch.core.types import hash_gumbel, sample_masked
    from repro_torch.nn.transformer import decoder_stacked_weights

    policy, optimizer = loop.policy, state.optimizer
    live = decoder_stacked_weights(policy.params["decoder"])
    cached = policy.kernel_weights()["stacked"]
    moved = all(not torch.equal(before[k], live[k]) for k in
                ("q_w", "ff1_w", "ff2_w"))
    fresh = all(torch.equal(cached[k], live[k]) for k in live)
    env = recipes.get_train("bitseq_tb").make_env(seed=0)
    params = env.init(device)
    B = 16
    _, state = env.reset(B, params)
    prev = torch.zeros(B, dtype=torch.int64, device=device)
    token, pos, length = env.observe_last(state, params, prev)
    ids = torch.arange(B, dtype=torch.int64, device=device)
    gumbel = hash_gumbel(torch.full_like(ids, 99), ids, torch.zeros_like(ids),
                         env.action_dim)
    mask = env.forward_mask(state, params)
    with torch.no_grad():
        out_p, _ = policy.apply_cached(policy.cache_init(B), token, pos,
                                       length, step=0)
        a_p, lp_p = sample_masked(out_p["logits"], mask, gumbel)
        a_f, lp_f, _, _ = policy.sample_cached(policy.cache_init(B), token,
                                               pos, length, gumbel, mask,
                                               step=0)
    torch.cuda.synchronize()
    same = bool(torch.equal(a_f.long(), a_p))
    err = float((lp_f - lp_p).abs().max())
    emit("trained_fused_step", optimizer=type(optimizer).__name__,
         foreach=optimizer.defaults.get("foreach"),
         fused=optimizer.defaults.get("fused"), weights_moved=moved,
         cache_equals_live_weights=fresh,
         actions_equal=same, log_pf_err=err)
    if not (moved and fresh and same and err <= TOL):
        raise AssertionError(
            f"trained fused step: weights moved {moved}, cache equals live "
            f"weights {fresh}, actions equal {same}, log_pf error {err}")


# -- phase 7: the sequence-design recipes -------------------------------------

def seqs_train_phase(device) -> dict:
    """``tfbind8_tb``, ``qm9_tb`` and ``amp_tb`` at full width through
    ``run_recipe`` (evals off; seqs_evals times them), launches read at
    every iteration and held to SEQ_LAUNCHES_PER_ITER exactly.  Returns
    the launches of all three runs."""
    from repro_torch.run import run_recipe

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name, iters in SEQ_ITERS.items():
        reset_launches()
        last = read_launches()
        per_it = []

        def log(line):
            if line.startswith("it "):
                now = read_launches()
                per_it.append({k: now[k] - last[k] for k in now})
                last.update(now)

        t0 = time.perf_counter()
        out = run_recipe(name, iterations=iters, seed=0, device=device,
                         eval_every=0, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = _only(launches, **SEQ_LAUNCHES_PER_ITER[name])
        bad = [(it, got) for it, got in enumerate(per_it) if got != want]
        if len(per_it) != iters or bad:
            raise AssertionError(f"{name}: {len(per_it)} iterations; "
                                 f"iterations launching other than {want}:"
                                 f" {bad[:3]}")
        hist = out["history"]
        if not all(math.isfinite(r[k]) for r in hist
                   for k in ("loss", "log_z", "mean_log_reward")):
            raise AssertionError(f"{name}: rows not finite: {hist[-2:]}")
        steady = (len(hist) - 1) / (hist[-1]["wall_s"] - hist[0]["wall_s"])
        emit("seqs_train", nvidia_smi=smi, recipe=name,
             env=SEQ_RECIPES[name], policy=SEQ_POLICIES[name], num_envs=16,
             iterations=iters, wall_s=wall, iterations_per_s=iters / wall,
             steady_iterations_per_s=steady,
             samples_per_s=16 * iters / wall,
             steady_samples_per_s=16 * steady,
             first={k: hist[0][k] for k in ("loss", "log_z",
                                            "mean_log_reward")},
             last={k: hist[-1][k] for k in ("loss", "log_z",
                                            "mean_log_reward")},
             launches=launches, launches_per_iteration=want)
        for k, v in launches.items():
            total[k] += v
    return total


def seqs_evals_phase(device) -> dict:
    """Each sequence recipe's eval suite once at full width (bitseq_tb's
    too: n=120, k=8), on a policy from a seeded generator, the sampling
    evals over 2,000 samples; and AMP's top-100 reward and diversity over
    256 samples.  Every metric finite, the correlations in [-1, 1].
    Returns the launches of the four suites (their non-exploring rollouts
    take the fused step; the log Z bounds' losses traj_logprob)."""
    from repro_torch import recipes
    from repro_torch.evals import EvalSuite
    from repro_torch.recipes.seqs import amp_eval

    smi = nvidia_smi()
    total = {k: 0 for k in wrappers()}
    for name in ("bitseq_tb", "tfbind8_tb", "qm9_tb", "amp_tb"):
        rec = recipes.get_train(name)
        env = rec.make_env()
        params = env.init(device)
        policy = rec.make_policy(env, seed=0, device=device)
        t0 = time.perf_counter()
        suite = EvalSuite(rec.make_evals(env, params, policy, seed=0,
                                         eval_batch=2000), every=1, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        suite.run(0)                 # warm: cuBLAS, the allocator
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        row = suite.run(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        extra = {}
        if name == "amp_tb":
            t1 = time.perf_counter()
            extra = amp_eval(env, params, policy)(7)
            torch.cuda.synchronize()
            extra["top100_seconds"] = time.perf_counter() - t1
        emit("seqs_evals", nvidia_smi=smi, recipe=name,
             evaluators=[type(e).__name__ for e in suite.evaluators],
             metrics=row, seconds=seconds, build_seconds=build_s,
             launches=launches, **extra)
        values = [v for k, v in row.items() if k != "step"] + [
            v for k, v in extra.items() if k != "top100_seconds"]
        corr = [row[k] for k in ("pearson", "spearman")]
        if not all(math.isfinite(v) for v in values) or not all(
                -1 <= c <= 1 for c in corr):
            raise AssertionError(f"{name} evals: {row} {extra}")
        for k, v in launches.items():
            total[k] += v
    return total


def seqs_profile(device) -> None:
    """One iteration of each sequence recipe, card against CPU
    (``hold_iteration``, phase seqs_hold), then that iteration's device
    idle share and tops on the card (phase seqs_profile); for AMP, the
    lengths decode_attention saw (seqs_kv_valid)."""
    for name in SEQ_ITERS:
        _, loop, state = hold_iteration("seqs_hold", name, device)
        if name == "amp_tb":
            # before any optimizer step: log Z starts at 150, far above
            # log R, and a few TB steps teach the policy not to stop
            amp_kv_valid(loop, state)
        profile_step("seqs_profile", lambda: loop.step(state), recipe=name)


def amp_kv_valid(loop, state) -> None:
    """An AMP rollout's cached queries on the card: at step t every layer's
    decode_attention must attend ``kv_valid = length_t + 1`` slots (the
    row's symbols so far and BOS), read back from the batch's
    observations, and the lengths must be ragged (rows stop at different
    steps)."""
    from repro_torch.nn import transformer

    seen = []
    real = transformer.decode_attention

    def spy(q, k, v, kv_valid):
        seen.append(kv_valid.clone())
        return real(q, k, v, kv_valid)

    transformer.decode_attention = spy
    try:
        batch = loop.sample(state)
    finally:
        transformer.decode_attention = real
    T = batch.actions.shape[0]
    layers = len(seen) // T
    want = (batch.obs[:-1] != loop.env.pad).sum(-1).to(torch.int32) + 1
    got = torch.stack(seen).reshape(T, layers, -1)
    same = bool(torch.equal(got, want[:, None, :].expand_as(got)))
    ragged = int(sum(len(set(row.tolist())) > 1 for row in want))
    emit("seqs_kv_valid", recipe="amp_tb", steps=T, layers=layers,
         launches=len(seen), kv_valid_equal_length_plus_1=same,
         ragged_steps=ragged, max_kv_valid=int(want.max()),
         stop_steps=sorted(set(batch.valid.sum(0).tolist())))
    if not same or layers != 3 or not ragged:
        raise AssertionError(f"AMP's decode_attention lengths: equal "
                             f"{same}, layers {layers}, ragged steps "
                             f"{ragged}")


# -- phase 8: Hymba-1.5B serving: decode and prompt scoring -----------------------

def hymba_config(**changes):
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("hymba-1.5b"), **changes)


def hymba_params(cfg, device, seed: int = 0):
    """Random full-width weights from a seeded generator on the card
    (1.39 B normal draws; on a host CPU that takes many seconds)."""
    from repro_torch.models import lm as LM
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return LM.init_params(cfg, generator=g, device=device)


def _only(launches: dict, **want) -> dict:
    return {k: want.get(k, 0) for k in launches}


def lm_decode_phase(cfg, params, device):
    """``repro_torch.launch.lm_decode.serve`` at full width and depth:
    batch 8, 32 prompt tokens prefilled one decode step at a time, then 32
    sampled tokens; one rwkv6_scan launch per layer and step, all on the
    route ``ops.scan_route`` gives at T = 1, no flash (decode attends the
    window cache in plain torch, as JAX does).  Returns the launches and
    the scan's launches by route."""
    from repro_torch.launch import lm_decode

    smi = nvidia_smi()
    lm_decode.serve(cfg, batch=DECODE_BATCH, prompt_len=2, gen=2, seed=1,
                    device=device, params=params)          # warm: cuBLAS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    toks, tps = lm_decode.serve(cfg, batch=DECODE_BATCH,
                                prompt_len=DECODE_PROMPT, gen=DECODE_GEN,
                                seed=0, device=device, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), scan_routes()
    steps = DECODE_PROMPT + DECODE_GEN
    want = _only(launches, rwkv6_scan=HYMBA_LAYERS * steps)
    from repro_torch.kernels import ops
    want_routes = {r: HYMBA_LAYERS * steps * (
        r == ops.scan_route(torch.bfloat16, 1)) for r in routes}
    n_params = sum(p.numel() for p in params.parameters())
    emit("lm_decode", nvidia_smi=smi, model=cfg.name,
         config={"layers": cfg.num_layers, "d_model": cfg.d_model,
                 "heads": [cfg.num_heads, cfg.num_kv_heads],
                 "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab_size, "ssm_state": cfg.ssm_state,
                 "window": cfg.sliding_window, "dtype": cfg.dtype},
         params=n_params, param_count_analytic=cfg.param_count(),
         batch=DECODE_BATCH, prompt_len=DECODE_PROMPT,
         gen=DECODE_GEN, decode_steps=steps, wall_s=wall,
         gen_tokens_per_s=tps, gen_steps_per_s=tps / DECODE_BATCH,
         steps_per_s=steps / wall,
         peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
         launches=launches, scan_routes=routes,
         first_tokens=toks[0, :8].tolist())
    if launches != want or routes != want_routes:
        raise AssertionError(f"lm_decode launched {launches}, expected "
                             f"{want}; scan routes {routes}, expected "
                             f"{want_routes}")
    if tuple(toks.shape) != (DECODE_BATCH, DECODE_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_decode tokens {tuple(toks.shape)} out of "
                             "range")
    return launches, routes


def prefill_batch(cfg, device):
    """The scoring pass's 2 x 4,096 random tokens (seeded) and targets."""
    g = torch.Generator(device=device)
    g.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                         generator=g, device=device)
    return {"tokens": toks, "targets": torch.roll(toks, -1, 1)}


def lm_prefill_phase(cfg, params, device):
    """``repro_torch.launch.steps.make_prefill_step`` at full width: 2 x
    4,096 tokens scored in one pass (past the 2,048 window, and 64 scan
    chunks of 64); exactly one flash launch (tensor-core route) and one
    scan launch (chunk route) per layer.  Returns the launches and the
    scan's launches by route."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_prefill_step

    smi = nvidia_smi()
    step = make_prefill_step(cfg)
    args = ({"model": params}, prefill_batch(cfg, device))
    step(*args)                                             # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lp = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes, s_routes = read_launches(), flash_routes(), scan_routes()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    flash_us = sum(t for n, t, _ in rows if FLASH_MATCH in n)
    scan_us = sum(t for n, t, _ in rows if SCAN_MATCH in n)
    finite = bool(torch.isfinite(lp).all())
    mean_lp = float(lp.mean())
    emit("lm_prefill", nvidia_smi=smi, model=cfg.name, batch=PREFILL_BATCH,
         seq_len=PREFILL_LEN, window=cfg.sliding_window, wall_s=wall,
         tokens_per_s=PREFILL_BATCH * PREFILL_LEN / wall,
         device_busy_us=busy, device_idle_share=1 - busy / (wall * 1e6),
         flash_us=flash_us, scan_us=scan_us,
         flash_share_of_busy=flash_us / busy,
         scan_share_of_busy=scan_us / busy,
         device_top=[{"name": k[:70], "device_us": t, "calls": c}
                     for k, t, c in rows[:8]],
         logprob_shape=list(lp.shape), finite=finite, mean_logprob=mean_lp,
         uniform_logprob=-math.log(cfg.vocab_size), launches=launches,
         flash_routes=routes, scan_routes=s_routes)
    want = _only(launches, flash_attention=HYMBA_LAYERS,
                 rwkv6_scan=HYMBA_LAYERS)
    # Hymba's bf16 heads of 64 take the tensor-core route, its bf16 SSM
    # scans over 4,096 steps the chunk route
    want_routes = {"wgmma": HYMBA_LAYERS, "simt": 0}
    want_scan = {"chunk": HYMBA_LAYERS, "recurrence": 0}
    if launches != want or routes != want_routes or s_routes != want_scan \
            or not flash_us > 0 or not scan_us > 0 \
            or tuple(lp.shape) != (PREFILL_BATCH, PREFILL_LEN) \
            or not finite or not float(lp.max()) <= 0.0:
        raise AssertionError(f"lm_prefill: launches {launches} (expected "
                             f"{want}), routes {routes} (expected "
                             f"{want_routes}), scan routes {s_routes} "
                             f"(expected {want_scan}), flash device time "
                             f"{flash_us} us, scan {scan_us} us, log-probs "
                             f"{tuple(lp.shape)}, finite {finite}, max "
                             f"{float(lp.max())}")
    return launches, s_routes


def scan_hold_phase(cfg, params, device) -> None:
    """Hymba's real decays through the chunk route.  During one full-width
    bf16 scoring pass (the ``lm_prefill`` batch), each layer's scan
    operands are captured by wrapping ``ops.rwkv6_scan`` as the model's
    layers see it (here only); on each
    layer's operands the chunk route is held against the step recurrence
    (``ref_rwkv6``), o as bf16 and the state as fp32 (``_held``, excess <=
    1), beside the smallest in-chunk decay product the layer saw (below
    1e-30 the JAX chunk form's clamp engages).  Then the same pass with
    ``ops.scan_route`` held at "recurrence": the mean |difference| of the
    two passes' log-probs is reported, not gated."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rwkv6
    from repro_torch.launch.steps import make_prefill_step

    from repro_torch.models import layers as model_layers

    step = make_prefill_step(cfg)
    args = ({"model": params}, prefill_batch(cfg, device))
    captured = []

    class CapturingOps:
        """``ops`` as the model's layers see it, with ``rwkv6_scan``
        wrapped: each call's operands are copied, then the wrapper runs
        (and counts its launch) as it would."""

        def __getattr__(self, name):
            return getattr(ops, name)

        @staticmethod
        def rwkv6_scan(r, k, v, w, u=None, state=None):
            captured.append(tuple(None if x is None else x.clone()
                                  for x in (r, k, v, w, u, state)))
            return ops.rwkv6_scan(r, k, v, w, u, state)

    reset_launches()
    model_layers.ops = CapturingOps()
    try:
        lp_chunk = step(*args)
    finally:
        model_layers.ops = ops
    routes = scan_routes()
    layers = []
    for r, k, v, w, u, s0 in captured:
        want_o, want_s = ref_rwkv6(r, k, v, w, u, s0)
        with forced_scan_route("chunk"):
            got_o, got_s = ops.rwkv6_scan(r, k, v, w, u, s0)
        logw = w.float().clamp(1e-8, 1.0).log()
        T = w.shape[1]
        pad = -T % ops.SCAN_CHUNK
        logw = torch.nn.functional.pad(logw, (0, 0, 0, 0, 0, pad))
        per_chunk = logw.reshape(w.shape[0], -1, ops.SCAN_CHUNK,
                                 *w.shape[2:]).sum(2)
        layers.append({
            "T": T, "dtype": str(r.dtype),
            "o_excess": _held(got_o, want_o, True)["excess"],
            "state_excess": _held(got_s, want_s, False)["excess"],
            "min_log10_chunk_decay": float(per_chunk.min()) / math.log(10)})
    del captured
    with forced_scan_route("recurrence"):
        lp_rec = step(*args)
    diff = (lp_chunk.float() - lp_rec.float()).abs()
    emit("scan_hold", model=cfg.name, layers=layers, scan_routes=routes,
         below_jax_clamp=sum(l["min_log10_chunk_decay"] < -30
                             for l in layers),
         logprob_mean_abs_diff_chunk_vs_recurrence=float(diff.mean()),
         logprob_max_abs_diff_chunk_vs_recurrence=float(diff.max()),
         tol=f"{BF16_RTOL:g} |want| + {BF16_ATOL_RMS:g} rms(want) (o), "
             f"{TOL:g} |want| + {TOL:g} rms(want) (state), entry by entry")
    bad = [i for i, l in enumerate(layers)
           if not (l["o_excess"] <= 1 and l["state_excess"] <= 1)]
    if len(layers) != HYMBA_LAYERS or bad \
            or routes != {"chunk": HYMBA_LAYERS, "recurrence": 0}:
        raise AssertionError(f"scan_hold: {len(layers)} layers captured, "
                             f"routes {routes}, layers over the check {bad}")


def lm_hold_phase(device) -> None:
    """A 2-layer full-width Hymba in fp32 (TF32 off), the same weights on
    the card (kernels) and the CPU (plain versions), with a 32-slot window:
    one 512-token scoring pass, log-probs within 1e-3; then 40 greedy
    decode steps, past the window, from the CPU's tokens: logits within
    1e-3 and the same argmax except where the CPU's top two lie within
    TIE_GAP."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import lm as LM

    cfg = hymba_config(num_layers=HOLD_LAYERS, dtype="float32",
                       sliding_window=HOLD_WINDOW)
    cpu = torch.device("cpu")
    p_c = LM.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device=cpu)
    p_g = LM.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device=device)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, HOLD_TOKENS), generator=g)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = make_prefill_step(cfg)
    lp_c = step({"model": p_c}, batch)
    lp_g = step({"model": p_g}, {k: t.to(device) for k, t in batch.items()})
    score_err = float((lp_g.cpu() - lp_c).abs().max())

    B = 2
    cache_c = LM.init_cache(cfg, B, HOLD_STEPS + 1, device=cpu)
    cache_g = LM.init_cache(cfg, B, HOLD_STEPS + 1, device=device)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    logit_err, mismatched, near_ties = 0.0, 0, 0
    with torch.no_grad():
        for _ in range(HOLD_STEPS):
            l_c, cache_c = LM.decode_step(p_c, cfg, tok, cache_c)
            l_g, cache_g = LM.decode_step(p_g, cfg, tok.to(device), cache_g)
            l_g = l_g.cpu()
            logit_err = max(logit_err, float((l_g - l_c).abs().max()))
            top2 = torch.topk(l_c, 2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) < TIE_GAP
            differ = torch.argmax(l_g, -1) != torch.argmax(l_c, -1)
            mismatched += int((differ & ~tie).sum())
            near_ties += int(tie.sum())
            tok = torch.argmax(l_c, -1)[:, None]
    ssm_err = float((cache_g["ssm"].cpu() - cache_c["ssm"]).abs().max())
    pos_equal = torch.equal(cache_g["kv"]["pos"].cpu(), cache_c["kv"]["pos"])
    emit("lm_hold", model=cfg.name, layers=HOLD_LAYERS, dtype="float32",
         tf32=torch.backends.cuda.matmul.allow_tf32, window=HOLD_WINDOW,
         score_tokens=HOLD_TOKENS, score_max_abs_err=score_err,
         decode_steps=HOLD_STEPS, batch=B, logits_max_abs_err=logit_err,
         argmax_mismatches=mismatched, near_ties=near_ties,
         ssm_state_max_abs_err=ssm_err, cache_positions_equal=pos_equal,
         tol=HOLD_TOL)
    if not (score_err <= HOLD_TOL and logit_err <= HOLD_TOL
            and mismatched == 0 and pos_equal):
        raise AssertionError(f"lm_hold: scoring error {score_err}, logits "
                             f"error {logit_err}, {mismatched} argmax "
                             f"mismatches, positions equal {pos_equal}")


def lm_profile(cfg, params, device) -> None:
    """One full-width decode step at batch 8 (:func:`profile_step`), after
    a few steps into the cache."""
    from repro_torch.models import lm as LM

    cache = LM.init_cache(cfg, DECODE_BATCH, DECODE_PROMPT + DECODE_GEN + 1,
                          device=device)
    tok = torch.zeros(DECODE_BATCH, 1, dtype=torch.int64, device=device)
    out = {}

    def step():
        with torch.no_grad():
            out["logits"], _ = LM.decode_step(params, cfg, tok, cache)

    for _ in range(3):
        step()
    profile_step("lm_profile", step, model=cfg.name, batch=DECODE_BATCH)
    if not bool(torch.isfinite(out["logits"]).all()):
        raise AssertionError("lm_profile: decode logits not finite")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of the parent commit: its decode_step, "
             "decode_attention, traj_logprob backward and subtb_loss "
             "kernels are built and timed beside this tree's on the same "
             "inputs (parent_kernel_us)")
    opts = parser.parse_args()
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
    seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        str(Path(tmp) / "single.so"),
                        *map(str, build.SOURCES)],
                       check=True, capture_output=True, timeout=600)
        single_s = time.perf_counter() - t0
    ptxas = named_ptxas(log)
    emit("build", seconds=seconds, single_nvcc_call_seconds=single_s,
         library=str(Path(path).relative_to(ROOT)), ptxas=ptxas,
         spilling=spilling(ptxas))
    parent = None
    if opts.parent is not None:
        parent, parent_ptxas = parent_library(opts.parent.resolve())
        emit("parent_build", sources=list(PARENT_SOURCES), ptxas=parent_ptxas,
             spilling=spilling(parent_ptxas))

    floor_us = launch_floor_us(device)
    # the serving batch and the lane counts the serve phase's requests are
    # held at (forward_rollout over 7, 16 and 200 samples), 128 (bitseq's
    # log Z bounds) and 256
    rows = [check_decode_step(B, 3, 16, 64, 8, 256, 3840, seed=B,
                              device=device, floor_us=floor_us, parent=parent)
            for B in (1, 7, 16, SERVE_LANES, 128, 200, 256)]
    rows.append(check_decode_step(5, 2, 9, 48, 6, 80, 203, seed=99,
                                  device=device, floor_us=floor_us,
                                  parent=parent))
    # the sequence recipes' eval rollouts (non-exploring: the fused step):
    # tfbind8's 256 and 2,000 lanes, AMP's 128 over 61 slots and its
    # top-100's 256
    rows += [check_decode_step(B, L, C, 64, 8, 256, A, seed=100 + B,
                               device=device, floor_us=floor_us)
             for B, L, C, A in ((256, 2, 9, 4), (2000, 2, 9, 4),
                                (128, 3, 61, 21), (256, 3, 61, 21))]
    main_row = next(r for r in rows if r["B"] == SERVE_LANES)
    check_decode_step_lanes(device)
    # the training rollout's shape first; odd S and H with empty rows; then
    # every head dim up to 64 at the training shape and at S = 100 (several
    # chunks of the online softmax)
    attn = [check_decode_attention(16, 16, 8, 8, list(range(1, 17)), seed=0,
                                   device=device, floor_us=floor_us,
                                   parent=parent),
            check_decode_attention(5, 37, 3, 8, [0, 1, 36, 37, 0], seed=1,
                                   device=device, floor_us=floor_us,
                                   parent=parent)]
    attn += [check_decode_attention(16, 16, 8, hd, list(range(1, 17)),
                                    seed=2 + hd, device=device,
                                    floor_us=floor_us, parent=parent)
             for hd in (16, 32, 64)]
    attn += [check_decode_attention(16, 100, 8, hd,
                                    [(7 * i) % 101 for i in range(16)],
                                    seed=3 + hd, device=device,
                                    floor_us=floor_us, parent=parent)
             for hd in (8, 16, 32, 64)]
    # tfbind8's training rollout (9 slots, BOS included) and AMP's (61
    # slots), ragged: rows stop at different steps
    attn += [check_decode_attention(16, 9, 8, 8,
                                    [1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9, 5,
                                     5, 1, 3], seed=20, device=device,
                                    floor_us=floor_us),
             check_decode_attention(16, 61, 8, 8,
                                    [1, 2, 6, 11, 61, 60, 33, 7, 61, 2, 45,
                                     19, 61, 30, 3, 58], seed=21,
                                    device=device, floor_us=floor_us)]
    traj = [check_traj_logprob(16, 15, 3840, seed=0, device=device,
                               floor_us=floor_us, parent=parent),
            check_traj_logprob(16, 15, 15, seed=1, device=device,
                               floor_us=floor_us, parent=parent),
            check_traj_logprob(3, 50, 203, seed=2, device=device,
                               floor_us=floor_us, parent=parent)]
    # the sequence recipes' losses (tfbind8 P_F, QM9 P_F), AMP's log Z
    # bounds (128 trajectories of 61 steps), the losses' P_B (tfbind8,
    # QM9); the other log Z bounds, P_F and P_B: bitseq's 128 x 15,
    # tfbind8's 256 x 8, QM9's 256 x 5, AMP's P_B, the hypergrid's 256 x 29
    traj += [check_traj_logprob(B, T, A, seed=10 + i, device=device,
                                floor_us=floor_us)
             for i, (B, T, A) in enumerate([
                 (16, 8, 4), (16, 5, 22), (128, 61, 21), (16, 8, 1),
                 (16, 5, 2), (128, 15, 3840), (128, 15, 15), (256, 8, 4),
                 (256, 8, 1), (256, 5, 22), (256, 5, 2), (128, 61, 2),
                 (256, 29, 5)])]
    # (16, 30) is the main path's (4x8^4, a warp per trajectory); 78 the
    # paper grid's; 7000 a long trajectory (a block of 896 threads); then
    # potentials at the offset log Z gives them (1e3), where JAX's expanded
    # prefix form cancels, as N(0, 1) and as a random walk, and lambda = 1;
    # 9000 takes two tiles (8 states x 1,024 threads each)
    subtb = [check_subtb(B, T1, lam, seed=i, device=device,
                         floor_us=floor_us, kind=kind, offset=offset,
                         parent=parent)
             for i, (B, T1, lam, kind, offset) in enumerate(
                 [(16, 30, 0.9, "normal", 0.0), (16, 78, 0.9, "normal", 0.0),
                  (3, 100, 0.8, "normal", 0.0), (1, 7, 0.5, "normal", 0.0),
                  (4, 200, 0.99, "normal", 0.0),
                  (3, 7000, 0.999, "normal", 0.0),
                  (16, 30, 0.9, "normal", 1e3),
                  (3, 7000, 0.999, "normal", 1e3),
                  (3, 7000, 0.999, "walk", 1e3),
                  (3, 7000, 1.0, "normal", 1e3),
                  (2, 9000, 0.999, "walk", 1e3)])]
    # the scoring pass's attention: Hymba's heads over 2 x 4,096 tokens in
    # bf16, window 2,048 (the tensor-core route), and the same geometry in
    # fp32 (the SIMT route; holds the skipping of key tiles outside the
    # window at TOL); then ragged, fp32, wide heads, a cached prefill; then
    # the tensor-core route at D = 128 non-causal, ragged, a cached prefill
    flash = [check_flash_attention(2, 4096, 4096, 25, 5, 64, causal=True,
                                   window=2048, bf16=True, seed=0,
                                   device=device),
             check_flash_attention(2, 4096, 4096, 25, 5, 64, causal=True,
                                   window=2048, bf16=False, seed=5,
                                   device=device),
             check_flash_attention(1, 17, 33, 2, 1, 16, causal=True,
                                   window=0, bf16=False, seed=1,
                                   device=device),
             check_flash_attention(2, 300, 300, 4, 2, 64, causal=True,
                                   window=64, bf16=False, seed=2,
                                   device=device),
             check_flash_attention(2, 64, 256, 4, 1, 128, causal=False,
                                   window=0, bf16=False, seed=3,
                                   device=device),
             check_flash_attention(2, 17, 64, 4, 2, 32, causal=True,
                                   window=16, q_offset=40, kv_len=57,
                                   bf16=False, seed=4, device=device),
             check_flash_attention(2, 64, 256, 4, 1, 128, causal=False,
                                   window=0, bf16=True, seed=6,
                                   device=device),
             check_flash_attention(1, 17, 33, 2, 1, 16, causal=True,
                                   window=0, bf16=True, seed=7,
                                   device=device),
             check_flash_attention(2, 17, 64, 4, 2, 32, causal=True,
                                   window=16, q_offset=40, kv_len=57,
                                   bf16=True, seed=8, device=device)]
    # Hymba's SSM heads: the scoring pass's (chunk route) and a decode
    # step's (recurrence), from a state; then ragged fp32 with u, and
    # RWKV6's 64 x 64 heads (recurrence); then on the chunk route RWKV6's
    # heads in bf16 with u, a ragged T, and the scoring shape at strong
    # decays (far below the JAX chunk form's 1e-30 clamp)
    scan = [check_rwkv6_scan(2, 4096, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=0, device=device),
            check_rwkv6_scan(8, 1, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=1, device=device),
            check_rwkv6_scan(1, 100, 3, 32, 32, bonus=True, state=True,
                             bf16=False, seed=2, device=device),
            check_rwkv6_scan(2, 300, 4, 64, 64, bonus=True, state=True,
                             bf16=False, seed=3, device=device),
            check_rwkv6_scan(2, 300, 4, 64, 64, bonus=True, state=True,
                             bf16=True, seed=4, device=device),
            check_rwkv6_scan(2, 1000, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=5, device=device),
            check_rwkv6_scan(2, 4096, 25, 16, 64, bonus=False, state=True,
                             bf16=True, seed=6, device=device,
                             decay="strong")]

    # the phases the kernels line counts record the shapes they launch at
    with recording_path_shapes():
        serve = serve_phase(device)
        train = train_phase(device)
    loop, state, before = train_hold_phase(device)
    train_profile(loop, state)
    trained_fused_step(loop, state, before, device)
    with recording_path_shapes():
        hypergrid = hypergrid_train_phase(device)
    _, loop, state = hold_iteration("hypergrid_hold", "hypergrid_subtb",
                                    device)
    train_profile(loop, state, phase="hypergrid_profile")
    hypergrid_converge(device)
    with recording_path_shapes():
        seqs = seqs_train_phase(device)
    seqs_profile(device)
    with recording_path_shapes():
        seqs_evals = seqs_evals_phase(device)
    check_path_shapes(rows, attn, traj)
    hymba = hymba_config()
    params = hymba_params(hymba, device)
    decode, decode_scan = lm_decode_phase(hymba, params, device)
    prefill, prefill_scan = lm_prefill_phase(hymba, params, device)
    scan_hold_phase(hymba, params, device)
    lm_profile(hymba, params, device)
    del params
    lm_hold_phase(device)

    def entry(name, source, replaces, launches, rows, main):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] if not isinstance(
                    r["max_abs_err"], dict) else max(r["max_abs_err"].values())
                    for r in rows),
                "ms": main["kernel_us"] / 1e3,
                "plain_ms": main["plain_us"] / 1e3,
                "bound_ms": main["bound_us"] / 1e3,
                "bound_by": main["bound_by"],
                "library_ms": None if main.get("library_us") is None
                else main["library_us"] / 1e3}

    def main_launches(kernel):
        """A kernel's launches on bitseq_tb's, the hypergrid's and the
        sequence recipes' paths (training and evals)."""
        return sum(p[kernel] for p in (train, hypergrid, seqs, seqs_evals))

    csrc = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        entry("decode_step", csrc + "decode_step.cu",
              "src/repro/kernels/decode_attention.py:239",
              serve["decode_step"] + seqs_evals["decode_step"], rows,
              main_row),
        entry("decode_attention", csrc + "decode_attention.cu",
              "src/repro/kernels/decode_attention.py:98",
              main_launches("decode_attention"), attn, attn[0]),
        entry("traj_logprob_fwd", csrc + "traj_logprob.cu",
              "src/repro/kernels/traj_logprob.py:61",
              main_launches("traj_logprob_fwd"), [f for f, _ in traj],
              traj[0][0]),
        entry("traj_logprob_bwd", csrc + "traj_logprob.cu",
              "src/repro/kernels/ops.py:130",
              main_launches("traj_logprob_bwd"), [b for _, b in traj],
              traj[0][1]),
        entry("subtb_loss_fwd", csrc + "subtb_loss.cu",
              "src/repro/kernels/subtb_loss.py:58",
              hypergrid["subtb_loss_fwd"], [f for f, _ in subtb],
              subtb[0][0]),
        entry("subtb_loss_bwd", csrc + "subtb_loss.cu",
              "src/repro/core/objectives.py:253",
              hypergrid["subtb_loss_bwd"], [b for _, b in subtb],
              subtb[0][1]),
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:75",
              prefill["flash_attention"], flash, flash[0]),
        # the scan's two routes (ops.scan_route): the step recurrence, on
        # decode's path (its row: a decode step), and the chunk kernels, on
        # the scoring pass's (its row: the scoring shape)
        dict(entry("rwkv6_scan", csrc + "rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:73",
                   decode_scan["recurrence"] + prefill_scan["recurrence"],
                   [r for r in scan if r["route"] == ["recurrence"]],
                   scan[1]), scan_route="recurrence"),
        dict(entry("rwkv6_chunk", csrc + "rwkv6_chunk.cu",
                   "src/repro/kernels/rwkv6_scan.py:73",
                   decode_scan["chunk"] + prefill_scan["chunk"],
                   [r for r in scan if r["route"] == ["chunk"]], scan[0]),
              scan_route="chunk"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
