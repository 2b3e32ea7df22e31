"""Where a fused decode step's time goes on the card, phase by phase.

    python3 scripts/decode_step_trace.py [--latency]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It copies ``src/repro_torch/kernels/csrc/decode_step.cu``, adds a
``clock64`` stamp at each phase boundary (read by block 0, thread 0: rank 0
of the first cluster), builds the copy into a library of its own and runs
it at the serving shape (L=3, C=16, D=64, H=8, F=256, A=3840) at B = 1, 64
and 256 lanes.  It prints each phase's cycles, the step's device time
(CUDA events and ``torch.profiler``), and how many of the kernel's
8-block clusters the card holds at once (``cudaOccupancyMaxActiveClusters``).
The stamps add a few instructions per phase; the times of the kernel that
ships are ``chip_smoke.py``'s.

``--latency`` instead times, on one cluster of 8 blocks x 256 threads, the
operations the step's chain is made of: a dependent L2 load, an L1 hit, a
shared-memory load, a shuffle, ``__syncthreads``, a cluster barrier alone
and after one remote store to each of the 8 ranks, and ``expf`` followed by
a division (cycles per operation, the second of two runs, warm).

Each line starts with the ``nvidia-smi`` name and power limit of the card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (anchor in decode_step.cu, stamp inserted before it or after it, name)
PHASES = [
    ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
     '"memory");\n\n  // inputs', "before", 0, "start"),
    ("  // 1. append", "before", 1, "init"),
    ("  // 2. latent query", "before", 2, "append"),
    ("    const uint32_t parity = l & 1;\n", "after", 3, "ln1+q"),
    ("    if (tid == 0) mbar_expect(bar_o", "before", 4, "attention"),
    ("    mbar_wait(bar_o, parity);  // o gathered\n", "after", 5, "o wait"),
    ("    if (tid == 0) mbar_expect(bar_hp", "before", 6, "proj"),
    ("    if (tid == 0) mbar_expect(bar_ff", "before", 7, "h wait+ln2+ff1"),
    ("    if (tid == 0) mbar_expect(bar_hf", "before", 8, "ff wait+ff2"),
    ("    mbar_wait(bar_hf, parity);  // h gathered\n", "after", 9, "h wait"),
    ("  // 3. readout of", "before", 40, "final ln"),
    ("  // warp w: lane w's", "before", 41, "readout gemv"),
    ("  if (tid == 0) mbar_expect(bar_stats", "before", 42, "max/sum"),
    ("  mbar_wait(bar_stats, 0);  // (max, sum) of every slice\n", "after",
     43, "max/sum wait"),
    ("  if (r == 0) {  // every slice's candidate", "before", 44, "argmax"),
    ("  if (r == 0 && warp < live && t == 0) {", "before", 45,
     "argmax wait"),
    ("  // no block leaves while", "before", 46, "outputs"),
]
LAYER_SLOTS = 10  # stamps 3..9 repeat per layer at 3 + 10 * l

EXTRA = '''
int repro_trace(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
int repro_max_clusters(int blocks, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * smem_layout(3, 64, 256, 8, 16, 3840).total;
  cudaFuncSetAttribute(decode_step_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)cfg.dynamicSmemBytes);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)decode_step_kernel,
                                             &cfg);
}
'''

LATENCY = r'''
#include <cuda_runtime.h>
#include <cstdint>
__device__ unsigned long long g_t[16];
#define STAMP(k, body) { unsigned long long t0 = clock64(); \
  for (int i = 0; i < n; ++i) { body; } \
  if (rec) g_t[k] = (clock64() - t0) / n; }
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(256)
lat(const int* __restrict__ big, const int* __restrict__ small, float* sink,
    int n) {
  __shared__ int sm[1024];
  __shared__ float rem[256];
  for (int i = threadIdx.x; i < 1024; i += 256) sm[i] = (i * 37 + 11) & 1023;
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
  const bool rec = blockIdx.x == 0 && threadIdx.x == 0;
  int k = threadIdx.x, k2 = threadIdx.x & 1023, k3 = threadIdx.x;
  float f = threadIdx.x;
  STAMP(0, int v; asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(big + k)); k = v)
  for (int i = 0; i < 64; ++i) k2 = __ldg(small + k2);
  STAMP(1, k2 = __ldg(small + k2))
  STAMP(2, k3 = sm[k3 & 1023])
  STAMP(3, f += __shfl_xor_sync(0xffffffffu, f, 1 + (i & 15)))
  STAMP(4, __syncthreads())
  STAMP(5, asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory"))
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(rem + threadIdx.x);
  STAMP(6, for (int q = 0; q < 8; ++q) { uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(q));
    asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(r), "f"(f) : "memory"); }
    asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory"))
  STAMP(7, f = expf(f * 1e-3f) / (f + 3.f))
  sink[blockIdx.x * 256 + threadIdx.x] = f + k + k2 + k3;
}
extern "C" int run(const int* big, const int* small, float* sink, int n,
                   unsigned long long* out) {
  lat<<<8, 256>>>(big, small, sink, n);
  cudaError_t e = cudaDeviceSynchronize();
  if (e) return e;
  return cudaMemcpyFromSymbol(out, g_t, sizeof(g_t));
}
'''
LATENCY_NAMES = ["L2 hit (dependent)", "L1 hit (dependent)", "shared load",
                 "shuffle", "__syncthreads", "cluster barrier",
                 "8 remote stores + cluster barrier", "expf + division"]


def build_lib(source: str, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    tmp = Path(tempfile.mkdtemp())
    src = tmp / f"{name}.cu"
    src.write_text(source)
    lib = tmp / f"lib{name}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def stamped_source() -> str:
    s = (ROOT / "src/repro_torch/kernels/csrc/decode_step.cu").read_text()
    s = s.replace("namespace {\n", "__device__ unsigned long long "
                  "g_trace[64];\n#define TRACE(k) if (blockIdx.x == 0 && "
                  "threadIdx.x == 0) g_trace[k] = clock64();\nnamespace {\n",
                  1)
    for anchor, where, k, _ in PHASES:
        if anchor not in s:
            raise RuntimeError(f"decode_step.cu has no {anchor!r}: update "
                               "PHASES")
        slot = f"{k} + {LAYER_SLOTS} * l" if 3 <= k < 40 else str(k)
        stamp = f"  TRACE({slot});\n"
        s = s.replace(anchor, stamp + anchor if where == "before"
                      else anchor + stamp, 1)
    return s.replace('extern "C" {\n', 'extern "C" {\n' + EXTRA, 1)


def phases(smi: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build
    lib = build_lib(stamped_source(), "decode_step_trace")
    lib.repro_decode_step.argtypes = [ctypes.POINTER(build.DecodeStepArgs),
                                      ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    n = ctypes.c_int(0)
    lib.repro_max_clusters(256, ctypes.byref(n))
    print(f"{smi}: resident 8-block clusters at once: {n.value}")
    names = {k: name for _, _, k, name in PHASES}
    for B in (1, 64, 256):
        inp = cs.random_step_inputs(B, 3, 16, 64, 8, 256, 3840, seed=B,
                                    device=dev)
        cache = {"k": inp["k"].clone(), "v": inp["v"].clone()}
        outs = (torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, device=dev), torch.empty(B, 64, device=dev))
        call = cs.parent_call(lib.repro_decode_step,
                              cs.step_args(inp, cache, outs, dev), dev)
        event_us = cs.cuda_time_us(call, iters=200)
        prof_us = cs.profiled_device_us(call)
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.repro_trace(buf)
        rows, prev = [], buf[0]
        for k in sorted(i for i in range(64) if buf[i]):
            label = (f"L{(k - 3) // LAYER_SLOTS} "
                     f"{names[3 + (k - 3) % LAYER_SLOTS]}"
                     if 3 <= k < 40 else names[k])
            if k:
                rows.append(f"{label}={buf[k] - prev}")
            prev = buf[k]
        print(f"{smi}: B={B} cycles={prev - buf[0]} event_us={event_us:.2f} "
              f"profiled_us={prof_us:.2f}")
        print("  " + " ".join(rows))


def latency(smi: str) -> None:
    lib = build_lib(LATENCY, "latency")
    g = torch.Generator().manual_seed(0)
    big = torch.randperm(1 << 24, generator=g).to(torch.int32).cuda()
    small = torch.randperm(1024, generator=g).to(torch.int32).cuda()
    sink = torch.empty(8 * 256, device="cuda")
    out = (ctypes.c_ulonglong * 16)()
    for _ in range(2):  # the second run finds the chain in L2
        err = lib.run(ctypes.c_void_p(big.data_ptr()),
                      ctypes.c_void_p(small.data_ptr()),
                      ctypes.c_void_p(sink.data_ptr()), 64, out)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    print(f"{smi}: cycles per operation: " + ", ".join(
        f"{name} {out[i]}" for i, name in enumerate(LATENCY_NAMES)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--latency", action="store_true",
                        help="time the chain's operations instead")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_step_trace: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    smi = cs.nvidia_smi()
    (latency if opts.latency else phases)(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
