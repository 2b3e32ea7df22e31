// The RWKV6 wkv recurrence (linear attention with per-channel decay), with
// an initial state, step by step on the fp32 cores of Hopper (sm_90a): the
// "recurrence" route of `ops.rwkv6_scan` (fp32 operands, and T below one
// 64-step chunk: a decode step is T = 1; `ops.scan_route`).  bf16 operands
// over T >= 64 take the chunk-parallel tensor-core kernel of
// rwkv6_chunk.cu instead.
//
// Replaces, on this route, the TPU kernel `rwkv6_scan_pallas`
// (src/repro/kernels/rwkv6_scan.py:73, pl.pallas_call at :99), and the
// model's jnp form `repro.models.layers.chunked_linear_attention` (:164)
// that Hymba's SSM heads and the RWKV blocks run.  Computes what
// `ref_rwkv6` (kernels/ref.py) computes, per (b, h), in fp32:
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t      (the u term only with u)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,          w_t clipped to [1e-8, 1]
// from S_0 = the given state (zeros without one).  r, k: (B, T, H, Dk);
// v: (B, T, H, Dv), all of one dtype (fp32 or bf16); w: (B, T, H, Dk)
// fp32; u: (H, Dk) fp32 or none; state: (B, H, Dk, Dv) fp32.  Writes o in
// r's dtype and the final state in fp32.  The Pallas kernel starts from
// zeros; the model always carries a state (decode runs this at T = 1).
// With `carry` set (a forward whose backward follows, rwkv6_scan_bwd.cu) it
// also writes the state entering every 64-step chunk, the layout of the
// chunk kernel's carry.
//
// Design.  One block per (b, h) and tile of 32 state columns j; four
// threads per column, on adjacent lanes, each keeping a quarter of the
// column S[:, j] (Dk / 4 floats) in registers for the whole sequence, so
// the state never leaves the chip between steps and a thread reads and
// writes only its own entries (state_in may alias state_out).  A step's
// r_t S_{t-1} is four partial dot products summed by two shuffles.  The
// sequence is walked in order (exact at any decay: no running product is
// divided by), 32 steps at a time: the block stages the chunk's r, k,
// w (clipped) and its v columns in shared memory with coalesced loads, then
// runs the 32 steps from shared memory (r, k, w are broadcast reads).  Dk
// up to 64 (padded to 16, 32 or 64 with r = k = 0, w = 1), any Dv.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s; 67 TFLOP/s fp32).  The
// decode step's call, (8, 1, 25) heads with Dk = 16, Dv = 64, moves 1.7 MB,
// mostly state: 0.5 us; it takes a few us, the launch and one dependent
// step.  Over long T the kernel is latency-bound (a block walks T dependent
// steps; at the scoring pass's (2, 4096, 25) only 100 blocks), which is why
// bf16 calls over T >= 64 take the chunk kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Kernel operands; mirrored field for field by `Rwkv6ScanArgs` in build.py.
// Every tensor contiguous.
struct Rwkv6ScanArgs {
  const void* r;          // (B, T, H, Dk), bf16 != 0: bf16, else fp32
  const void* k;          // (B, T, H, Dk)
  const void* v;          // (B, T, H, Dv)
  const float* w;         // (B, T, H, Dk)
  const float* u;         // (H, Dk) or null: no bonus term
  const float* state_in;  // (B, H, Dk, Dv) or null: zeros
  void* out;              // (B, T, H, Dv), r's dtype
  float* state_out;       // (B, H, Dk, Dv)
  float* carry;           // (B, H, ceil(T / 64), Dk, Dv) or null
  int batch, steps, num_heads, dk, dv, bf16, device;
};

namespace {

constexpr int kChunk = 32;   // steps staged in shared memory at a time
constexpr int kCols = 32;    // state columns per block
constexpr int kGroups = 4;   // threads per column, each Dk / 4 rows
constexpr int kThreads = kCols * kGroups;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// sum over the kGroups adjacent lanes of a column
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <typename E, int DK>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(
    const Rwkv6ScanArgs a) {
  constexpr int RPT = DK / kGroups;  // state rows per thread
  __shared__ float rs[kChunk][DK], ks[kChunk][DK], ws[kChunk][DK];
  __shared__ float vs[kChunk][kCols];

  const int H = a.num_heads, T = a.steps, Dk = a.dk, Dv = a.dv;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = threadIdx.x % kGroups, col = threadIdx.x / kGroups;
  const int j0 = blockIdx.y * kCols, j = j0 + col;
  const bool live = j < Dv;
  const E* rg = static_cast<const E*>(a.r);
  const E* kg = static_cast<const E*>(a.k);
  const E* vg = static_cast<const E*>(a.v);
  E* og = static_cast<E*>(a.out);
  const size_t state_base = ((size_t)b * H + h) * Dk * Dv;

  float S[RPT], u[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = g * RPT + i;
    S[i] = (live && row < Dk && a.state_in)
               ? a.state_in[state_base + (size_t)row * Dv + j]
               : 0.f;
    u[i] = (a.u && row < Dk) ? a.u[h * Dk + row] : 0.f;
  }
  const bool bonus = a.u != nullptr;

  const int n_saved = (T + 2 * kChunk - 1) / (2 * kChunk);
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    if (a.carry != nullptr && live && t0 % (2 * kChunk) == 0) {
      // the state entering this 64-step chunk, for the backward pass
      float* dst = a.carry +
                   ((((size_t)b * H + h) * n_saved + t0 / (2 * kChunk)) * Dk) *
                       Dv;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = g * RPT + i;
        if (row < Dk) dst[(size_t)row * Dv + j] = S[i];
      }
    }
    __syncthreads();  // the last chunk is read
    for (int idx = threadIdx.x; idx < kChunk * DK; idx += kThreads) {
      const int tt = idx / DK, i = idx % DK;
      const bool in = tt < n && i < Dk;
      const size_t src = (((size_t)b * T + t0 + tt) * H + h) * Dk + i;
      rs[tt][i] = in ? to_f32(rg[src]) : 0.f;
      ks[tt][i] = in ? to_f32(kg[src]) : 0.f;
      ws[tt][i] = in ? fminf(fmaxf(a.w[src], 1e-8f), 1.0f) : 1.f;
    }
    for (int idx = threadIdx.x; idx < kChunk * kCols; idx += kThreads) {
      const int tt = idx / kCols, jj = j0 + idx % kCols;
      const size_t src = (((size_t)b * T + t0 + tt) * H + h) * Dv + jj;
      vs[tt][idx % kCols] = (tt < n && jj < Dv) ? to_f32(vg[src]) : 0.f;
    }
    __syncthreads();
    // every lane runs the steps (the shuffles need the whole warp); a
    // column past Dv holds zeros and stores nothing
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][col];
      float o = 0.f, ruk = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = g * RPT + i;
        o = fmaf(rs[tt][row], S[i], o);
        if (bonus) ruk = fmaf(rs[tt][row] * u[i], ks[tt][row], ruk);
      }
      o = group_sum(o);
      if (bonus) o = fmaf(group_sum(ruk), vj, o);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = g * RPT + i;
        S[i] = fmaf(ws[tt][row], S[i], ks[tt][row] * vj);
      }
      if (live && g == 0)
        store(og + (((size_t)b * T + t0 + tt) * H + h) * Dv + j, o);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g * RPT + i;
      if (row < Dk) a.state_out[state_base + (size_t)row * Dv + j] = S[i];
    }
  }
}

template <typename E, int DK>
int launch(const Rwkv6ScanArgs& a, cudaStream_t stream) {
  const dim3 grid(a.batch * a.num_heads, (a.dv + kCols - 1) / kCols);
  rwkv6_scan_kernel<E, DK><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const Rwkv6ScanArgs& a, cudaStream_t s) {
  if (a.dk <= 16) return launch<E, 16>(a, s);
  if (a.dk <= 32) return launch<E, 32>(a, s);
  return launch<E, 64>(a, s);
}

}  // namespace

extern "C" {

// Launches one scan on `stream`; returns a cudaError_t (0 = success).
// Dk above 64 and negative sizes are refused (cudaErrorInvalidValue).
int repro_rwkv6_scan(const Rwkv6ScanArgs* args, void* stream) {
  const Rwkv6ScanArgs& a = *args;
  if (a.batch < 0 || a.steps < 0 || a.num_heads < 1 || a.dk < 1 ||
      a.dk > 64 || a.dv < 1 || (a.dv + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // extern "C"
