// The RWKV6 wkv recurrence, backward, chunk-parallel on Hopper (sm_90a):
// the "chunk" route of `ops.rwkv6_scan_backward` (`ops.scan_bwd_route`: bf16
// r, k, v with T >= 64, the forward's chunk route; fp32 operands and short T
// take the step recurrence of rwkv6_scan_bwd.cu).
//
// Replaces JAX's autodiff of the jnp layer `repro.models.layers.
// chunked_linear_attention` (src/repro/models/layers.py:164), which the TPU
// package differentiates when it trains (the Pallas kernel
// `rwkv6_scan_pallas`, src/repro/kernels/rwkv6_scan.py:73, has no backward
// of its own).  Computes what `ref_rwkv6_bwd` (kernels/ref.py) computes:
// for the forward, per (b, h),
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t      (the u term only with u)
//   S_t = diag(c(w_t)) S_{t-1} + k_t^T v_t,       c(w) = clip(w, 1e-8, 1)
// and the cotangents dO and dS_T, with G_t the adjoint of S_t (G_T = dS_T,
// G_{t-1} = diag(c(w_t)) G_t + r_t^T dO_t):
//   dr_t = S_{t-1} dO_t + u k_t (v_t . dO_t),  dk_t = G_t v_t + r_t u (v_t .
//   dO_t),  dv_t = G_t^T k_t + (r_t . u . k_t) dO_t,
//   dw_t = rowsum(S_{t-1} * G_t) c'(w_t),  du = sum r_t k_t (v_t . dO_t),
//   dS_0 = G_0,
// with JAX's c'(w): 1/2 at w = 1e-8 or w = 1 exactly.  r, k, v, dO: (B, T,
// H, Dk / Dv) bf16, Dk, Dv <= 64; w (B, T, H, Dk) fp32 unclipped; u (H, Dk)
// fp32 or none; the forward's `carry` (B, H, n, Dk, Dv), the state entering
// each 64-step chunk.  dr, dk, dv in bf16; dw, dS_0 and du's per-chunk parts
// in fp32 (the wrapper sums du over batch rows and chunks in a fixed order).
//
// Design.  Chunks of C = 64 steps, as the forward's; four launches on the
// stream, no atomics (a repeated call is bitwise equal):
//   1. (rwkv6_chunk.cu, `repro_rwkv6_chunk_adjoint`, launched first by the
//      wrapper) each chunk's own contribution to the adjoint entering it,
//      sum_s (r_s 2^{L_s})^T dO_s with L_s the log2-cumsum of the clipped
//      decays before step s (every exponent <= 0), on `mma.sync` as the
//      forward's state pass forms a chunk's own state (the decayed r in
//      two bf16 parts, dO whole), and its decay 2^{L_C};
//   2. carry (one thread per (b, h, state entry)): from dS_T, walks the
//      chunks from the last, G <- decay_c G + local_c, writing G at each
//      chunk's end over local_c, and dS_0;
//   3. cols (one block per (b, h, chunk)): the adjoint walked back from G at
//      the chunk's end, dv_t = G_t^T k_t (+ the u term);
//   4. rows (one block per (b, h, chunk)): the state walked forward from
//      the forward's carry, dr_t = S_{t-1} dO_t, keeping S every 8 steps in
//      shared memory; then the adjoint walked back from G at the chunk's
//      end, each 8-step segment's states rebuilt from its checkpoint in
//      registers: dk_t = G_t v_t and dw_t = rowsum(S_{t-1} G_t) c'(w_t),
//      with no division by w (the chunk identity d log w = reverse cumsum(r
//      dr - k dk) gives dw only after one, and w reaches 1e-8:
//      tests/test_torch_rwkv6_chunk_bwd.py shows it failing).
// Each thread of 3. and 4. owns 8 entries of one state row (4.) or
// column (3.), so each per-step sum is first taken in the thread (in
// two chains), then over the 2-8 lanes that share the row or column, 8
// steps at a time (a transposed reduction: 7 shuffles for 8 steps at 8
// lanes).  A block stages its chunk's operands in shared memory as fp32,
// in 16-byte loads all in flight at once.  Every product and sum of 2.-4.
// is fp32, as in the plain version; no per-step state leaves the chip.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s; 67 TFLOP/s fp32).  At
// rwkv6-1.6b's training call, (2, 4096, 32) heads of 64 / 64 in bf16, the
// function reads r, k, v, dO, w and writes dr, dk, dv, dw: 0.37 GB, 0.110
// ms; its work, about 12 flops per state entry a step, is 12.9 GFLOP
// (0.192 ms): bound by operations.  At Hymba's 16 / 64 (25 heads) the
// bytes bind: 0.131 GB, 0.039 ms.  Passes 3 and 4 do about 20 fp32
// operations per state entry a step (the state walked forward, then
// rebuilt per segment; the adjoint walked twice) on 3,200 or 4,096 blocks
// of 64 steps each, in place of the step recurrence's 50 or 64 blocks
// walking 4,096 dependent steps; at 64 x 64 the rows pass holds one
// 512-thread block a SM (128 registers a thread), so its walks are
// latency-bound (PERF.md, §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// Kernel operands; mirrored field for field by `Rwkv6ChunkBwdArgs` in
// build.py.  Every tensor contiguous.
struct Rwkv6ChunkBwdArgs {
  const __nv_bfloat16* r;   // (B, T, H, Dk)
  const __nv_bfloat16* k;   // (B, T, H, Dk)
  const __nv_bfloat16* v;   // (B, T, H, Dv)
  const float* w;           // (B, T, H, Dk), unclipped
  const float* u;           // (H, Dk) or null: no bonus term
  const float* carry;       // (B, H, n, Dk, Dv): the state entering chunk c
  const __nv_bfloat16* dout;  // (B, T, H, Dv)
  const float* dstate_out;  // (B, H, Dk, Dv) or null: zeros
  float* gstate;            // (B, H, n, Dk, Dv): each chunk's own adjoint
                            // (pass 1), overwritten with the adjoint at its
                            // end
  const float* decay;       // (B, H, n, Dk): each chunk's decay (pass 1)
  __nv_bfloat16* grad_r;    // (B, T, H, Dk)
  __nv_bfloat16* grad_k;    // (B, T, H, Dk)
  __nv_bfloat16* grad_v;    // (B, T, H, Dv)
  float* grad_w;            // (B, T, H, Dk)
  float* grad_u;            // (B, H, n, Dk) per chunk, or null (no u)
  float* grad_state;        // (B, H, Dk, Dv)
  int batch, steps, num_heads, dk, dv, device;
};

namespace {

constexpr int kChunk = 64;  // steps per chunk (the forward's carry)
constexpr int kSeg = 8;     // steps per checkpoint and per batched reduction
constexpr int kSlice = 8;   // state entries per thread

__device__ __forceinline__ float clip_w(float w) {
  return fminf(fmaxf(w, 1e-8f), 1.0f);
}
// d clip(w, 1e-8, 1) / dw, as JAX's jnp.clip: 1/2 on either bound
__device__ __forceinline__ float clip_grad(float w) {
  if (w > 1e-8f && w < 1.0f) return 1.f;
  return (w == 1e-8f || w == 1.0f) ? 0.5f : 0.f;
}

// The thread's 8 entries of its row (column): two runs of 4 at 4 s and
// 4 L + 4 s, where s is its lane in the L lanes sharing the row, so that
// a float4 load of each run from shared memory is conflict-free.
template <int L>
__device__ __forceinline__ int slice_at(int s, int i) {
  return i < 4 ? 4 * s + i : 4 * L + 4 * s + (i - 4);
}

// Sums x[0..8) (8 steps' partial sums) over the L adjacent lanes of a
// group: a transposed reduction; after it, lane s of the group holds the
// sums of steps s * (8 / L) + i in x[i], i < 8 / L.
template <int L, int N>
__device__ __forceinline__ void reduce_steps(float (&x)[kSeg], int lane) {
  if constexpr (L > 1) {
    constexpr int n = N / 2, o = L / 2;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? x[i] : x[i + n];
      const float keep = upper ? x[i + n] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    reduce_steps<o, n>(x, lane);
  }
}

// One chunk's operands in shared memory, as fp32.  Steps past T read as
// r = k = v = dO = 0, w = 1; rows past Dk and columns past Dv as 0 (w = 1).
// w is kept raw (the rows pass clips it where it uses it and reads c'(w)
// from it) or clipped (the cols pass).
template <int DKP, int DVP>
struct Stage {
  float r[kChunk][DKP], k[kChunk][DKP], w[kChunk][DKP];
  float v[kChunk][DVP], g[kChunk][DVP];  // g: dO
  float vdo[kChunk];                     // v_t . dO_t
  float ruk[kChunk];                     // r_t . u . k_t
  float u[DKP];
};

__device__ __forceinline__ void unpack8(uint4 q, float* dst) {
  const uint32_t x[4] = {q.x, q.y, q.z, q.w};
  float4 lo, hi;
  lo.x = __uint_as_float(x[0] << 16), lo.y = __uint_as_float(x[0] & 0xffff0000u);
  lo.z = __uint_as_float(x[1] << 16), lo.w = __uint_as_float(x[1] & 0xffff0000u);
  hi.x = __uint_as_float(x[2] << 16), hi.y = __uint_as_float(x[2] & 0xffff0000u);
  hi.z = __uint_as_float(x[3] << 16), hi.w = __uint_as_float(x[3] & 0xffff0000u);
  *reinterpret_cast<float4*>(dst) = lo;
  *reinterpret_cast<float4*>(dst + 4) = hi;
}

__device__ __forceinline__ float4 clip4(float4 w) {
  return make_float4(clip_w(w.x), clip_w(w.y), clip_w(w.z), clip_w(w.w));
}

// Stage chunk t0 of (b, h).  VEC (Dk and Dv multiples of 8, every operand
// on a 16-byte boundary): each row moves in 16-byte loads, all of a
// thread's issued before any of its shared-memory stores; else element by
// element.  WITH_V: v and the u terms' v . dO too (the rows pass).
template <int DKP, int DVP, bool VEC, bool WITH_V, bool RAW_W>
__device__ void stage(const Rwkv6ChunkBwdArgs& a, Stage<DKP, DVP>& sm, int b,
                      int h, int t0) {
  const int T = a.steps, H = a.num_heads, Dk = a.dk, Dv = a.dv;
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (VEC) {
    constexpr int NT = DKP * DVP / kSlice;
    constexpr int NK = kChunk * DKP / 8 / NT, NV = kChunk * DVP / 8 / NT;
    uint4 rq[NK], kq[NK], vq[NV], gq[NV];
    float4 wq[NK][2];
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int x = tid + i * NT, t = x / (DKP / 8), d = 8 * (x % (DKP / 8));
      const bool in = t0 + t < T && d < Dk;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dk + d;
      rq[i] = in ? __ldg(reinterpret_cast<const uint4*>(a.r + src)) : zero;
      kq[i] = in ? __ldg(reinterpret_cast<const uint4*>(a.k + src)) : zero;
      wq[i][0] = in ? __ldg(reinterpret_cast<const float4*>(a.w + src)) : one;
      wq[i][1] = in ? __ldg(reinterpret_cast<const float4*>(a.w + src + 4))
                    : one;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int x = tid + i * NT, t = x / (DVP / 8), j = 8 * (x % (DVP / 8));
      const bool in = t0 + t < T && j < Dv;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dv + j;
      if constexpr (WITH_V)
        vq[i] = in ? __ldg(reinterpret_cast<const uint4*>(a.v + src)) : zero;
      gq[i] = in ? __ldg(reinterpret_cast<const uint4*>(a.dout + src)) : zero;
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int x = tid + i * NT, t = x / (DKP / 8), d = 8 * (x % (DKP / 8));
      unpack8(rq[i], &sm.r[t][d]);
      unpack8(kq[i], &sm.k[t][d]);
      *reinterpret_cast<float4*>(&sm.w[t][d]) = RAW_W ? wq[i][0]
                                                      : clip4(wq[i][0]);
      *reinterpret_cast<float4*>(&sm.w[t][d + 4]) = RAW_W ? wq[i][1]
                                                          : clip4(wq[i][1]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int x = tid + i * NT, t = x / (DVP / 8), j = 8 * (x % (DVP / 8));
      if constexpr (WITH_V) unpack8(vq[i], &sm.v[t][j]);
      unpack8(gq[i], &sm.g[t][j]);
    }
  } else {
    for (int i = tid; i < kChunk * DKP; i += nt) {
      const int t = i / DKP, d = i % DKP;
      const bool in = t0 + t < T && d < Dk;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dk + d;
      sm.r[t][d] = in ? __bfloat162float(a.r[src]) : 0.f;
      sm.k[t][d] = in ? __bfloat162float(a.k[src]) : 0.f;
      const float w = in ? a.w[src] : 1.f;
      sm.w[t][d] = RAW_W ? w : clip_w(w);
    }
    for (int i = tid; i < kChunk * DVP; i += nt) {
      const int t = i / DVP, j = i % DVP;
      const bool in = t0 + t < T && j < Dv;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dv + j;
      if constexpr (WITH_V) sm.v[t][j] = in ? __bfloat162float(a.v[src]) : 0.f;
      sm.g[t][j] = in ? __bfloat162float(a.dout[src]) : 0.f;
    }
  }
  for (int d = tid; d < DKP; d += nt)
    sm.u[d] = (a.u != nullptr && d < Dk) ? a.u[h * Dk + d] : 0.f;
  __syncthreads();
  // a warp per step: the dot products of the u terms
  const int lane = tid & 31;
  for (int t = tid >> 5; t < kChunk; t += nt >> 5) {
    float x = 0.f, y = 0.f;
    if constexpr (WITH_V)
      for (int j = lane; j < DVP; j += 32) x = fmaf(sm.v[t][j], sm.g[t][j], x);
    for (int d = lane; d < DKP; d += 32)
      y = fmaf(sm.r[t][d] * sm.u[d], sm.k[t][d], y);
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
      y += __shfl_xor_sync(0xffffffffu, y, o);
    }
    if (lane == 0) {
      sm.vdo[t] = x;
      sm.ruk[t] = y;
    }
  }
  __syncthreads();
}

// Eight floats of a shared-memory row at the thread's slice.
template <int L>
__device__ __forceinline__ void load_slice(const float* row, int s,
                                           float (&x)[kSlice]) {
  const float4 p = *reinterpret_cast<const float4*>(row + 4 * s);
  const float4 q = *reinterpret_cast<const float4*>(row + 4 * L + 4 * s);
  x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w;
  x[4] = q.x, x[5] = q.y, x[6] = q.z, x[7] = q.w;
}

// ---- 3. cols: dv --------------------------------------------------------------

// Thread (j, s): column j of the adjoint, rows slice_at<L>(s, .), L =
// DKP / 8 lanes a column, walked back from gstate[c] (the adjoint at the
// chunk's end).
template <int DKP, int DVP, bool VEC>
__global__ void __launch_bounds__(DKP * DVP / kSlice)
    rwkv6_chunk_bwd_cols_kernel(const Rwkv6ChunkBwdArgs a) {
  constexpr int L = DKP / kSlice;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<DKP, DVP>& sm = *reinterpret_cast<Stage<DKP, DVP>*>(smem_raw);
  const int T = a.steps, H = a.num_heads, Dk = a.dk, Dv = a.dv;
  const int n = (T + kChunk - 1) / kChunk;
  const int bh = blockIdx.x / n, c = blockIdx.x % n;
  const int b = bh / H, h = bh % H, t0 = c * kChunk;
  stage<DKP, DVP, VEC, false, false>(a, sm, b, h, t0);

  const int tid = threadIdx.x, lane = tid & 31;
  const int j = tid / L, s = tid % L;
  const float* gs = a.gstate + ((size_t)bh * n + c) * Dk * Dv;
  float G[kSlice];
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    const int d = slice_at<L>(s, e);
    G[e] = (d < Dk && j < Dv) ? gs[(size_t)d * Dv + j] : 0.f;
  }
  for (int seg = kChunk / kSeg - 1; seg >= 0; --seg) {
    float x[kSeg];
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      const int t = seg * kSeg + i;
      float wv[kSlice], rv[kSlice], kv[kSlice];
      load_slice<L>(sm.w[t], s, wv);
      load_slice<L>(sm.r[t], s, rv);
      load_slice<L>(sm.k[t], s, kv);
      const float gj = sm.g[t][j];
      float a0 = 0.f, a1 = 0.f;  // two chains
#pragma unroll
      for (int e = 0; e < kSlice; e += 2) {
        a0 = fmaf(G[e], kv[e], a0);
        a1 = fmaf(G[e + 1], kv[e + 1], a1);
      }
      x[i] = a0 + a1;
#pragma unroll
      for (int e = 0; e < kSlice; ++e) G[e] = fmaf(wv[e], G[e], rv[e] * gj);
    }
    reduce_steps<L, kSeg>(x, lane);
#pragma unroll
    for (int i = 0; i < kSeg / L; ++i) {
      const int t = seg * kSeg + s * (kSeg / L) + i, tt = t0 + t;
      if (j < Dv && tt < T)
        a.grad_v[(((size_t)b * T + tt) * H + h) * Dv + j] =
            __float2bfloat16(fmaf(sm.ruk[t], sm.g[t][j], x[i]));
    }
  }
}

// ---- 2. carry: the adjoint at each chunk's end --------------------------------

constexpr int kCarryThreads = 256;

__global__ void __launch_bounds__(kCarryThreads)
    rwkv6_chunk_bwd_carry_kernel(const Rwkv6ChunkBwdArgs a) {
  const int Dk = a.dk, Dv = a.dv;
  const int n = (a.steps + kChunk - 1) / kChunk;
  const size_t entries = (size_t)Dk * Dv;
  const size_t idx = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (idx >= (size_t)a.batch * a.num_heads * entries) return;
  const size_t bh = idx / entries, e = idx % entries;
  const int d = (int)(e / Dv);
  float G = a.dstate_out ? a.dstate_out[idx] : 0.f;
  float* gs = a.gstate + bh * n * entries + e;
  const float* decay = a.decay + bh * n * Dk + d;
  constexpr int kBatch = 32;  // loads of a batch issued before its stores
  for (int c1 = n; c1 > 0; c1 -= kBatch) {
    float local[kBatch], dc[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c1 - 1 - i;
      local[i] = c >= 0 ? gs[(size_t)c * entries] : 0.f;
      dc[i] = c >= 0 ? decay[(size_t)c * Dk] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c1 - 1 - i;
      if (c >= 0) {
        gs[(size_t)c * entries] = G;
        G = fmaf(dc[i], G, local[i]);
      }
    }
  }
  a.grad_state[idx] = G;
}

// ---- 4. rows: dr, dk, dw, du ---------------------------------------------------

// Thread (d, s): row d of the state and of the adjoint, columns
// slice_at<L>(s, .), L = DVP / 8 lanes a row.  Shared memory: the staged
// chunk (w raw), then the state at every 8th step, [segment][entry][thread].
// Each per-step sum runs in two chains (even and odd entries).
template <int DKP, int DVP, bool VEC>
__global__ void __launch_bounds__(DKP * DVP / kSlice, 1)
    rwkv6_chunk_bwd_rows_kernel(const Rwkv6ChunkBwdArgs a) {
  constexpr int L = DVP / kSlice, NT = DKP * L;
  constexpr int kPer = kSeg / L;  // steps per lane after a reduction
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<DKP, DVP>& sm = *reinterpret_cast<Stage<DKP, DVP>*>(smem_raw);
  float* ckpt = reinterpret_cast<float*>(smem_raw + sizeof(Stage<DKP, DVP>));
  const int T = a.steps, H = a.num_heads, Dk = a.dk, Dv = a.dv;
  const int n = (T + kChunk - 1) / kChunk;
  const int bh = blockIdx.x / n, c = blockIdx.x % n;
  const int b = bh / H, h = bh % H, t0 = c * kChunk;
  stage<DKP, DVP, VEC, true, true>(a, sm, b, h, t0);

  const int tid = threadIdx.x, lane = tid & 31;
  const int d = tid / L, s = tid % L;
  const bool row = d < Dk;
  const size_t ent = ((size_t)bh * n + c) * Dk * Dv;
  const float ud = sm.u[d];
  float S[kSlice];
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    const int j = slice_at<L>(s, e);
    S[e] = (row && j < Dv) ? a.carry[ent + (size_t)d * Dv + j] : 0.f;
  }

  // the state forward: dr_t = S_{t-1} dO_t, S_{t-1} kept every 8 steps
  float du = 0.f;
  for (int seg = 0; seg < kChunk / kSeg; ++seg) {
#pragma unroll
    for (int e = 0; e < kSlice; ++e)
      ckpt[(seg * kSlice + e) * NT + tid] = S[e];
    float x[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = seg * kSeg + i;
      float gv[kSlice], vv[kSlice];
      load_slice<L>(sm.g[t], s, gv);
      load_slice<L>(sm.v[t], s, vv);
      const float w = clip_w(sm.w[t][d]), kd = sm.k[t][d];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int e = 0; e < kSlice; e += 2) {
        a0 = fmaf(S[e], gv[e], a0);
        a1 = fmaf(S[e + 1], gv[e + 1], a1);
      }
#pragma unroll
      for (int e = 0; e < kSlice; ++e) S[e] = fmaf(w, S[e], kd * vv[e]);
      x[i] = a0 + a1;
    }
    reduce_steps<L, kSeg>(x, lane);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = seg * kSeg + s * kPer + i, tt = t0 + t;
      if (row && tt < T) {
        const float vd = sm.vdo[t], kd = sm.k[t][d];
        a.grad_r[(((size_t)b * T + tt) * H + h) * Dk + d] =
            __float2bfloat16(fmaf(ud * kd, vd, x[i]));
        du = fmaf(sm.r[t][d] * kd, vd, du);
      }
    }
  }

  // the adjoint backward from the chunk's end: dk_t = G_t v_t, dw_t =
  // rowsum(S_{t-1} G_t) c'(w_t); each segment's states rebuilt first (by
  // the forward walk's operations: the same bits)
  float G[kSlice];
  const float* gs = a.gstate + ent;
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    const int j = slice_at<L>(s, e);
    G[e] = (row && j < Dv) ? gs[(size_t)d * Dv + j] : 0.f;
  }
  for (int seg = kChunk / kSeg - 1; seg >= 0; --seg) {
    float P[kSeg][kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) P[0][e] = ckpt[(seg * kSlice + e) * NT + tid];
#pragma unroll
    for (int i = 1; i < kSeg; ++i) {
      const int t = seg * kSeg + i - 1;
      float vv[kSlice];
      load_slice<L>(sm.v[t], s, vv);
      const float w = clip_w(sm.w[t][d]), kd = sm.k[t][d];
#pragma unroll
      for (int e = 0; e < kSlice; ++e) P[i][e] = fmaf(w, P[i - 1][e], kd * vv[e]);
    }
    float xk[kSeg], xw[kSeg];
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      const int t = seg * kSeg + i;
      float gv[kSlice], vv[kSlice];
      load_slice<L>(sm.g[t], s, gv);
      load_slice<L>(sm.v[t], s, vv);
      const float w = clip_w(sm.w[t][d]), rd = sm.r[t][d];
      float k0 = 0.f, k1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
      for (int e = 0; e < kSlice; e += 2) {
        k0 = fmaf(G[e], vv[e], k0);
        k1 = fmaf(G[e + 1], vv[e + 1], k1);
        w0 = fmaf(P[i][e], G[e], w0);
        w1 = fmaf(P[i][e + 1], G[e + 1], w1);
      }
#pragma unroll
      for (int e = 0; e < kSlice; ++e) G[e] = fmaf(w, G[e], rd * gv[e]);
      xk[i] = k0 + k1;
      xw[i] = w0 + w1;
    }
    reduce_steps<L, kSeg>(xk, lane);
    reduce_steps<L, kSeg>(xw, lane);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = seg * kSeg + s * kPer + i, tt = t0 + t;
      if (row && tt < T) {
        const size_t dst = (((size_t)b * T + tt) * H + h) * Dk + d;
        a.grad_k[dst] = __float2bfloat16(
            fmaf(sm.r[t][d] * ud, sm.vdo[t], xk[i]));
        a.grad_w[dst] = xw[i] * clip_grad(sm.w[t][d]);
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) du += __shfl_xor_sync(0xffffffffu, du, o);
  if (a.grad_u != nullptr && row && s == 0)
    a.grad_u[((size_t)bh * n + c) * Dk + d] = du;
}

template <int DKP, int DVP, bool VEC>
int launch(const Rwkv6ChunkBwdArgs& a, cudaStream_t stream) {
  constexpr int NT = DKP * DVP / kSlice;
  const size_t stage_bytes = sizeof(Stage<DKP, DVP>);
  const size_t rows_bytes =
      stage_bytes + sizeof(float) * (kChunk / kSeg) * kSlice * NT;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_chunk_bwd_cols_kernel<DKP, DVP, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stage_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_chunk_bwd_rows_kernel<DKP, DVP, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)rows_bytes);
    if (err != cudaSuccess) return (int)err;
    attrs = true;
  }
  const int n = (a.steps + kChunk - 1) / kChunk;
  const unsigned blocks = (unsigned)((size_t)a.batch * a.num_heads * n);
  const size_t entries = (size_t)a.batch * a.num_heads * a.dk * a.dv;
  rwkv6_chunk_bwd_carry_kernel<<<
      (unsigned)((entries + kCarryThreads - 1) / kCarryThreads),
      kCarryThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  rwkv6_chunk_bwd_cols_kernel<DKP, DVP, VEC>
      <<<blocks, NT, stage_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunk_bwd_rows_kernel<DKP, DVP, VEC>
      <<<blocks, NT, rows_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DKP, int DVP>
int dispatch_vec(const Rwkv6ChunkBwdArgs& a, cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.dk % 8 == 0 && a.dv % 8 == 0 && aligned(a.r) &&
                   aligned(a.k) && aligned(a.v) && aligned(a.w) &&
                   aligned(a.dout);
  return vec ? launch<DKP, DVP, true>(a, s) : launch<DKP, DVP, false>(a, s);
}

template <int DKP>
int dispatch(const Rwkv6ChunkBwdArgs& a, cudaStream_t s) {
  if (a.dv <= 16) return dispatch_vec<DKP, 16>(a, s);
  if (a.dv <= 32) return dispatch_vec<DKP, 32>(a, s);
  return dispatch_vec<DKP, 64>(a, s);
}

}  // namespace

extern "C" {

// Launches passes 2-4 of the chunk-parallel backward (three kernels) on
// `stream`, after pass 1 (`repro_rwkv6_chunk_adjoint`) filled gstate and
// decay; returns a cudaError_t (0 = success).  Dk or Dv above 64, negative
// sizes and more (batch row, head, chunk) blocks than a grid takes are
// refused (cudaErrorInvalidValue).
int repro_rwkv6_chunk_bwd(const Rwkv6ChunkBwdArgs* args, void* stream) {
  const Rwkv6ChunkBwdArgs& a = *args;
  if (a.batch < 0 || a.steps < 0 || a.num_heads < 1 || a.dk < 1 ||
      a.dk > 64 || a.dv < 1 || a.dv > 64 ||
      (long long)a.batch * a.num_heads * ((a.steps + kChunk - 1) / kChunk) >
          2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dk <= 16) return dispatch<16>(a, s);
  if (a.dk <= 32) return dispatch<32>(a, s);
  return dispatch<64>(a, s);
}

}  // extern "C"
