// The RWKV6 wkv recurrence, backward, for Hopper (sm_90a), on the fp32
// cores.
//
// Replaces JAX's autodiff of the jnp layer `repro.models.layers.
// chunked_linear_attention` (src/repro/models/layers.py:164), which the TPU
// package differentiates when it trains (the Pallas kernel
// `rwkv6_scan_pallas`, src/repro/kernels/rwkv6_scan.py:73, has no backward
// of its own).  Computes what `ref_rwkv6_bwd` (kernels/ref.py) computes:
// for the forward, per (b, h),
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t      (the u term only with u)
//   S_t = diag(c(w_t)) S_{t-1} + k_t^T v_t,       c(w) = clip(w, 1e-8, 1)
// and the cotangents dO (B, T, H, Dv) and dS_T (the final state's, or
// zeros), with G_t the adjoint of S_t (G_T = dS_T,
// G_{t-1} = diag(c(w_t)) G_t + r_t^T dO_t):
//   dr_t = S_{t-1} dO_t + u k_t (v_t . dO_t)
//   dk_t = G_t v_t + r_t u (v_t . dO_t)
//   dv_t = G_t^T k_t + (r_t . u . k_t) dO_t
//   dw_t = rowsum(S_{t-1} * G_t) c'(w_t)
//   du   = sum_{b, t} r_t k_t (v_t . dO_t)
//   dS_0 = G_0
// with c'(w) = 1 inside (1e-8, 1), 0 outside [1e-8, 1] and 1/2 at w = 1e-8
// or w = 1 exactly: JAX's derivative of jnp.clip there (torch's clamp
// gives 1).  r, k: (B, T, H, Dk) and v: (B, T, H, Dv) of one dtype (fp32
// or bf16), Dk <= 64, Dv <= 64; w (B, T, H, Dk) fp32 unclipped; u (H, Dk)
// fp32 or none.  Every product and sum is fp32; dr, dk, dv are written in
// r's dtype, dw in fp32, du per batch row (the wrapper sums over b).
//
// Design.  Nothing runs the recurrence backwards by dividing by w (w
// reaches 1e-8; a divided state is the instability of JAX's 1e-30 clamp).
// The forward saves the state entering every 64-step chunk (`carry`, B, H,
// n, Dk, Dv: the chunk kernel's carry, or the recurrence kernel's with
// `carry` set).  One launch, one block of 256 threads per (b, h) and role:
//   - role 0 (dv, dS_0): the state's adjoint G in registers, column j of G
//     over 256 / Dv' lanes (Dv' = Dv padded to 16, 32 or 64), walked from
//     t = T down to 1; dv_t[j] is a sum over the rows, a shuffle among
//     the column's lanes;
//   - role 1 (dr, dk, dw, du): row i of S and G over 256 / Dk' lanes.  Per
//     chunk, from last to first: the chunk's states S_{t-1} are recomputed
//     from its entering state, walking forward, into a per-thread scratch
//     in device memory (each thread reads back only what it wrote, 64
//     steps x Dk' Dv' floats a block); then the chunk is walked backward
//     with G carried across chunks, and dr, dk, dw are sums over the
//     columns, shuffles among the row's lanes.
// A chunk's r, k, w, v, dO are staged in shared memory by coalesced loads.
// No atomics: two runs give the same bits.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s; 67 TFLOP/s fp32).  The
// function reads r, k, v, dO and w and writes dr, dk, dv and dw.  At
// rwkv6-1.6b's training call, (2, 4096, 32) heads of 64 / 64 in bf16, that
// is 4 x 33.5 MB read, 3 x 33.5 MB written and 2 x 67 MB of fp32 w and dw
// (0.37 GB, 0.110 ms); its work, about 12 flops per state entry a step, is
// 12.9 GFLOP (0.192 ms): bound by operations.  At Hymba's 16 / 64 (25
// heads) the bytes bind: 0.131 GB, 0.039 ms.  The kernel walks T
// dependent steps twice in role 1 with only B H blocks per role, so it is
// latency-bound far above that bound (PERF.md, §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Kernel operands; mirrored field for field by `Rwkv6ScanBwdArgs` in
// build.py.  Every tensor contiguous.
struct Rwkv6ScanBwdArgs {
  const void* r;            // (B, T, H, Dk), bf16 != 0: bf16, else fp32
  const void* k;            // (B, T, H, Dk)
  const void* v;            // (B, T, H, Dv)
  const float* w;           // (B, T, H, Dk), unclipped
  const float* u;           // (H, Dk) or null: no bonus term
  const float* carry;       // (B, H, n, Dk, Dv): the state entering chunk c
  const void* dout;         // (B, T, H, Dv), r's dtype
  const float* dstate_out;  // (B, H, Dk, Dv) or null: zeros
  float* scratch;           // (B H, 64 Dk' Dv') floats, Dk' and Dv' Dk and
                            // Dv padded to 16, 32 or 64
  void* grad_r;             // (B, T, H, Dk), r's dtype
  void* grad_k;             // (B, T, H, Dk)
  void* grad_v;             // (B, T, H, Dv)
  float* grad_w;            // (B, T, H, Dk)
  float* grad_u;            // (B, H, Dk) per batch row, or null (no u)
  float* grad_state;        // (B, H, Dk, Dv)
  int batch, steps, num_heads, dk, dv, bf16, device;
};

namespace {

constexpr int kChunk = 64;  // steps per saved state (rwkv6_chunk.cu's C)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float clip_w(float w) {
  return fminf(fmaxf(w, 1e-8f), 1.0f);
}
// d clip(w, 1e-8, 1) / dw, as JAX's jnp.clip: 1/2 on either bound
__device__ __forceinline__ float clip_grad(float w) {
  if (w > 1e-8f && w < 1.0f) return 1.f;
  return (w == 1e-8f || w == 1.0f) ? 0.5f : 0.f;
}

// sum over the N adjacent lanes of a group (N a power of two <= 32)
template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory of a staged chunk, in floats
template <int DKP, int DVP>
struct Stage {
  static constexpr int kVS = DVP + 1;  // padded rows of v and dO
  static constexpr size_t kFloats =
      (size_t)3 * kChunk * DKP + (size_t)2 * kChunk * kVS + kChunk;
};

// stage steps [t0, t0 + n) of (b, h): r, k, raw w (1 past Dk), v, dO
template <typename E, int DKP, int DVP>
__device__ void stage(const Rwkv6ScanBwdArgs& a, int b, int h, int t0, int n,
                      float* rs, float* ks, float* ws, float* vs, float* gs) {
  constexpr int VS = Stage<DKP, DVP>::kVS;
  const int H = a.num_heads, T = a.steps, Dk = a.dk, Dv = a.dv;
  const E* rg = static_cast<const E*>(a.r);
  const E* kg = static_cast<const E*>(a.k);
  const E* vg = static_cast<const E*>(a.v);
  const E* gg = static_cast<const E*>(a.dout);
  for (int idx = threadIdx.x; idx < kChunk * DKP; idx += kThreads) {
    const int tt = idx / DKP, i = idx % DKP;
    const bool in = tt < n && i < Dk;
    const size_t src = (((size_t)b * T + t0 + tt) * H + h) * Dk + i;
    rs[idx] = in ? to_f32(rg[src]) : 0.f;
    ks[idx] = in ? to_f32(kg[src]) : 0.f;
    ws[idx] = in ? a.w[src] : 1.f;
  }
  for (int idx = threadIdx.x; idx < kChunk * DVP; idx += kThreads) {
    const int tt = idx / DVP, j = idx % DVP;
    const bool in = tt < n && j < Dv;
    const size_t src = (((size_t)b * T + t0 + tt) * H + h) * Dv + j;
    vs[tt * VS + j] = in ? to_f32(vg[src]) : 0.f;
    gs[tt * VS + j] = in ? to_f32(gg[src]) : 0.f;
  }
}

template <typename E, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_bwd_kernel(const Rwkv6ScanBwdArgs a) {
  constexpr int VS = Stage<DKP, DVP>::kVS;
  extern __shared__ float smem[];
  float* rs = smem;                    // kChunk x DKP
  float* ks = rs + kChunk * DKP;       // kChunk x DKP
  float* ws = ks + kChunk * DKP;       // kChunk x DKP, raw
  float* vs = ws + kChunk * DKP;       // kChunk x VS
  float* gs = vs + kChunk * VS;        // kChunk x VS (dO)
  float* vdo = gs + kChunk * VS;       // kChunk: v_t . dO_t

  const int H = a.num_heads, T = a.steps, Dk = a.dk, Dv = a.dv;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const bool bonus = a.u != nullptr;
  const size_t state_base = (size_t)bh * Dk * Dv;

  if (blockIdx.y == 0) {
    // ---- role 0: dv and dS_0; column layout ------------------------------
    constexpr int NR = kThreads / DVP;  // lanes per column
    constexpr int RPT = DKP / NR;       // rows per lane: g + NR * ii
    const int col = tid / NR, g = tid % NR;
    const bool live = col < Dv;
    float G[RPT], u[RPT];
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii) {
      const int row = g + NR * ii;
      G[ii] = (live && row < Dk && a.dstate_out)
                  ? a.dstate_out[state_base + (size_t)row * Dv + col]
                  : 0.f;
      u[ii] = (bonus && row < Dk) ? a.u[h * Dk + row] : 0.f;
    }
    E* dvg = static_cast<E*>(a.grad_v);
    for (int c = n_chunks - 1; c >= 0; --c) {
      const int t0 = c * kChunk, n = min(kChunk, T - t0);
      __syncthreads();  // the last chunk is read
      stage<E, DKP, DVP>(a, b, h, t0, n, rs, ks, ws, vs, gs);
      __syncthreads();
      for (int tt = n - 1; tt >= 0; --tt) {
        const float* rt = rs + tt * DKP;
        const float* kt = ks + tt * DKP;
        const float* wt = ws + tt * DKP;
        const float gj = gs[tt * VS + col];
        float gk = 0.f, ruk = 0.f;
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii) {
          const int row = g + NR * ii;
          gk = fmaf(G[ii], kt[row], gk);
          if (bonus) ruk = fmaf(rt[row] * u[ii], kt[row], ruk);
        }
        gk = group_sum<NR>(gk);
        if (bonus) gk = fmaf(group_sum<NR>(ruk), gj, gk);
        if (live && g == 0)
          store(dvg + (((size_t)b * T + t0 + tt) * H + h) * Dv + col, gk);
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii) {
          const int row = g + NR * ii;
          G[ii] = fmaf(clip_w(wt[row]), G[ii], rt[row] * gj);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii) {
        const int row = g + NR * ii;
        if (row < Dk)
          a.grad_state[state_base + (size_t)row * Dv + col] = G[ii];
      }
    }
    return;
  }

  // ---- role 1: dr, dk, dw, du; row layout --------------------------------
  constexpr int NG = kThreads / DKP;  // lanes per row
  constexpr int CPT = DVP / NG;       // columns per lane: cg + NG * cc
  const int row = tid / NG, cg = tid % NG;
  const bool live = row < Dk;
  const float u_row = (bonus && live) ? a.u[h * Dk + row] : 0.f;
  float G[CPT], S[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int col = cg + NG * cc;
    G[cc] = (live && col < Dv && a.dstate_out)
                ? a.dstate_out[state_base + (size_t)row * Dv + col]
                : 0.f;
  }
  float* scratch = a.scratch + (size_t)bh * kChunk * DKP * DVP;
  E* drg = static_cast<E*>(a.grad_r);
  E* dkg = static_cast<E*>(a.grad_k);
  float du = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    __syncthreads();  // the last chunk is read
    stage<E, DKP, DVP>(a, b, h, t0, n, rs, ks, ws, vs, gs);
    __syncthreads();
    if (tid < kChunk) {
      float s = 0.f;
      for (int j = 0; j < DVP; ++j)
        s = fmaf(vs[tid * VS + j], gs[tid * VS + j], s);
      vdo[tid] = s;
    }
    // the chunk's states S_{t-1}, from the state entering it
    const float* s_in = a.carry + ((size_t)bh * n_chunks + c) * Dk * Dv;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = cg + NG * cc;
      S[cc] = (live && col < Dv) ? s_in[(size_t)row * Dv + col] : 0.f;
    }
    for (int tt = 0; tt < n; ++tt) {
      const float wr = clip_w(ws[tt * DKP + row]), kr = ks[tt * DKP + row];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        scratch[((size_t)tt * CPT + cc) * kThreads + tid] = S[cc];
        S[cc] = fmaf(wr, S[cc], kr * vs[tt * VS + cg + NG * cc]);
      }
    }
    __syncthreads();  // vdo is written
    for (int tt = n - 1; tt >= 0; --tt) {
      const float rr = rs[tt * DKP + row], kr = ks[tt * DKP + row];
      const float w_raw = ws[tt * DKP + row];
      float gv = 0.f, sd = 0.f, sg = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = cg + NG * cc;
        const float s = scratch[((size_t)tt * CPT + cc) * kThreads + tid];
        const float gj = gs[tt * VS + col];
        gv = fmaf(G[cc], vs[tt * VS + col], gv);
        sd = fmaf(s, gj, sd);
        sg = fmaf(s, G[cc], sg);
      }
      gv = group_sum<NG>(gv);
      sd = group_sum<NG>(sd);
      sg = group_sum<NG>(sg);
      if (live && cg == 0) {
        const float vd = vdo[tt];
        const size_t dst = (((size_t)b * T + t0 + tt) * H + h) * Dk + row;
        store(drg + dst, bonus ? fmaf(u_row * kr, vd, sd) : sd);
        store(dkg + dst, bonus ? fmaf(rr * u_row, vd, gv) : gv);
        a.grad_w[dst] = sg * clip_grad(w_raw);
        du = fmaf(rr * kr, vd, du);
      }
      const float wr = clip_w(w_raw);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        G[cc] = fmaf(wr, G[cc], rr * gs[tt * VS + cg + NG * cc]);
    }
  }
  if (bonus && live && cg == 0) a.grad_u[(size_t)bh * Dk + row] = du;
}

template <typename E, int DKP, int DVP>
int launch(const Rwkv6ScanBwdArgs& a, cudaStream_t stream) {
  const size_t bytes = Stage<DKP, DVP>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<E, DKP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.num_heads, 2);
  rwkv6_scan_bwd_kernel<E, DKP, DVP><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E, int DKP>
int dispatch_v(const Rwkv6ScanBwdArgs& a, cudaStream_t s) {
  if (a.dv <= 16) return launch<E, DKP, 16>(a, s);
  if (a.dv <= 32) return launch<E, DKP, 32>(a, s);
  return launch<E, DKP, 64>(a, s);
}

template <typename E>
int dispatch(const Rwkv6ScanBwdArgs& a, cudaStream_t s) {
  if (a.dk <= 16) return dispatch_v<E, 16>(a, s);
  if (a.dk <= 32) return dispatch_v<E, 32>(a, s);
  return dispatch_v<E, 64>(a, s);
}

}  // namespace

extern "C" {

// Launches the backward scan on `stream`; returns a cudaError_t (0 =
// success).  Dk or Dv above 64 and negative sizes are refused
// (cudaErrorInvalidValue).
int repro_rwkv6_scan_bwd(const Rwkv6ScanBwdArgs* args, void* stream) {
  const Rwkv6ScanBwdArgs& a = *args;
  if (a.batch < 0 || a.steps < 0 || a.num_heads < 1 || a.dk < 1 ||
      a.dk > 64 || a.dv < 1 || a.dv > 64 ||
      (long long)a.batch * a.num_heads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // extern "C"
