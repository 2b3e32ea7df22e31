// GQA streaming-softmax (flash) attention, backward, for Hopper (sm_90a), on
// the fp32 cores.
//
// Replaces JAX's autodiff of the jnp layer `repro.models.layers.
// flash_attention` (src/repro/models/layers.py:94), which the TPU package
// differentiates when it trains; the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:75) has no backward of its own.
// Computes what `ref_flash_attention_bwd` (kernels/ref.py) computes: given
// q (B, Sq, H, D), k/v (B, Skv, KVH, D), the forward's output `out` and row
// log-sum-exp `lse` (B, H, Sq) (flash_attention.cu or
// flash_attention_wgmma.cu with `lse` set), and the cotangent `dout`,
//   P    = exp(q.k / sqrt(D) - lse) on the attended keys, 0 elsewhere
//   dV_j = sum_i P_ij dO_i              (summed over each kv head's group)
//   dS   = P (dO_i . v_j - Delta_i),    Delta_i = dO_i . out_i
//   dQ_i = sum_j dS_ij k_j / sqrt(D),   dK_j = sum_i dS_ij q_i / sqrt(D)
// with the forward's mask: query row i at position i attends key j iff
// j < Skv, with `causal` j <= i, with `window` > 0 j > i - window (no
// q_offset, no kv_len: only cached decode passes those, and it never
// differentiates).  Sq may differ from Skv (Whisper's cross-attention).
// Every product and sum is fp32; dq, dk, dv are written in q's dtype (fp32
// or bf16), D <= 128.
//
// Design (FlashAttention-2's backward, without atomics).  Three launches on
// the stream:
//   1. delta: one warp per (b, i, h) row, Delta = rowsum(dO * out) in fp32;
//   2. dq: one block of 256 threads per (64-row query tile, query head,
//      batch row), the forward kernel's layout: the tile's q and dO stay in
//      shared memory, 64-key K and V tiles stream through it (only the
//      tiles some row attends); thread (ty, tx) scores rows 4 ty .. +3
//      against keys tx + 16 j for both q.k and dO.v, forms dS, and after
//      one pass of dS through shared memory accumulates its rows' dQ
//      columns tx + 16 c in registers;
//   3. dkdv: one block per (64-key tile, kv head, batch row): K and V stay
//      in shared memory, and the block walks every query head of the kv
//      head's group and every 64-row query tile that attends the key tile,
//      accumulating dK and dV of its keys in registers, so the group's sum
//      is formed in one block in a fixed order.
// No atomics: two runs give the same bits.  A masked score gives P = 0
// exactly (no exp of -inf - lse), so a row that attends no key (lse = -inf)
// contributes nothing.  Ragged Sq / Skv and D < DMAX are masked in the
// loads (zero-filled) and the stores.
//
// What bounds it (H100 SXM data sheet: 989 TFLOP/s bf16 dense tensor
// cores, 67 TFLOP/s fp32, 3.35 TB/s).  The backward does 2.5x the forward's
// products (S, dP, dV, dK, dQ against the forward's S, PV): at Hymba's
// training call, q (2, 4096, 25, 64) against k/v (2, 4096, 5, 64) with a
// 2048 window, 2.5 x 8.0e10 = 2.0e11 flops, 0.20 ms on the tensor cores,
// against ~130 MB moved: bound by operations.  This first kernel runs them
// on the fp32 cores from shared memory (the dq pass recomputes S and dP,
// 14 D flops a pair in all), so it sits far above that bound (PERF.md,
// §6); a wgmma redesign is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "flash_attention_bwd.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // rows (queries or keys) per thread
constexpr int kOther = 4;      // columns of the score tile per thread
constexpr int kPStride = kBlockK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool attended(const FlashAttentionBwdArgs& a,
                                         int qi, int key) {
  return qi < a.q_len && key < a.kv_size && (!a.causal || key <= qi) &&
         (a.window <= 0 || key > qi - a.window);
}

// rows x DMAX of a (B, S, heads, D) tensor at (b, row0.., head) into
// shared memory as fp32 (row stride DMAX + 1), zeros past S and D
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int heads,
                                          int head, int D) {
  for (int i = threadIdx.x; i < 64 * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX, row = row0 + r;
    dst[r * (DMAX + 1) + d] =
        (row < S && d < D)
            ? to_f32(src[(((size_t)b * S + row) * heads + head) * D + d])
            : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const FlashAttentionBwdArgs a) {
  const int H = a.num_heads, Sq = a.q_len, D = a.head_dim;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.batch * Sq * H) return;  // the whole warp
  const T* o = static_cast<const T*>(a.out) + (size_t)row * D;
  const T* g = static_cast<const T*>(a.dout) + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    // row walks (b, i, h) in memory order
    const int h = (int)(row % H), i = (int)((row / H) % Sq);
    const int b = (int)(row / H / Sq);
    a.delta[((size_t)b * H + h) * Sq + i] = s;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashAttentionBwdArgs a) {
  constexpr int QS = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // kBlockQ x QS
  float* dos = qs + kBlockQ * QS;     // kBlockQ x QS
  float* ks = dos + kBlockQ * QS;     // kBlockK x QS
  float* vs = ks + kBlockK * QS;      // kBlockK x QS
  float* ds = vs + kBlockK * QS;      // kBlockQ x kPStride
  __shared__ float lse_s[kBlockQ], delta_s[kBlockQ];

  const int Sq = a.q_len, Skv = a.kv_size, H = a.num_heads, D = a.head_dim;
  const int KVH = a.num_kv_heads;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf((float)D);

  load_tile<T, DMAX>(qs, static_cast<const T*>(a.q), b, q0, Sq, H, h, D);
  load_tile<T, DMAX>(dos, static_cast<const T*>(a.dout), b, q0, Sq, H, h, D);
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    const size_t idx = ((size_t)b * H + h) * Sq + row;
    lse_s[tid] = row < Sq ? a.lse[idx] : 0.f;
    delta_s[tid] = row < Sq ? a.delta[idx] : 0.f;
  }

  // keys that some row of this tile attends: [k_lo, k_hi)
  const int pos_last = min(q0 + kBlockQ, Sq) - 1;
  int k_lo = 0, k_hi = Skv;
  if (a.causal) k_hi = min(k_hi, pos_last + 1);
  if (a.window > 0) k_lo = max(k_lo, q0 - a.window + 1);
  const int t_begin = (k_lo / kBlockK) * kBlockK;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int kt = t_begin; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // the last tile's k, v, ds are read (q, dO stored)
    load_tile<T, DMAX>(ks, static_cast<const T*>(a.k), b, kt, Skv, KVH, kvh,
                       D);
    load_tile<T, DMAX>(vs, static_cast<const T*>(a.v), b, kt, Skv, KVH, kvh,
                       D);
    __syncthreads();

    float s[kRows][kOther], dp[kRows][kOther];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOther; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float qv[kRows], gv[kRows], kv[kOther], vv[kOther];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * QS + d];
        gv[i] = dos[(ty * kRows + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < kOther; ++j) {
        kv[j] = ks[(tx + 16 * j) * QS + d];
        vv[j] = vs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOther; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kOther; ++j) {
        float g = 0.f;
        if (attended(a, q0 + r, kt + tx + 16 * j)) {
          const float p = expf(fmaf(s[i][j], scale, -lse_s[r]));
          g = p * (dp[i][j] - delta_s[r]);
        }
        ds[r * kPStride + tx + 16 * j] = g;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float gv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        gv[i] = ds[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(gv[i], kv[c], acc[i][c]);
    }
  }

  T* dqg = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    T* drow = dqg + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(drow + d, acc[i][c] * scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const FlashAttentionBwdArgs a) {
  constexpr int QS = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* ks = smem;                   // kBlockK x QS
  float* vs = ks + kBlockK * QS;      // kBlockK x QS
  float* qs = vs + kBlockK * QS;      // kBlockQ x QS
  float* dos = qs + kBlockQ * QS;     // kBlockQ x QS
  float* ps = dos + kBlockQ * QS;     // kBlockK x kPStride: P^T
  float* ds = ps + kBlockK * kPStride;  // kBlockK x kPStride: dS^T
  __shared__ float lse_s[kBlockQ], delta_s[kBlockQ];

  const int Sq = a.q_len, Skv = a.kv_size, H = a.num_heads, D = a.head_dim;
  const int KVH = a.num_kv_heads, G = H / KVH;
  const int k0 = blockIdx.x * kBlockK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf((float)D);

  load_tile<T, DMAX>(ks, static_cast<const T*>(a.k), b, k0, Skv, KVH, kvh, D);
  load_tile<T, DMAX>(vs, static_cast<const T*>(a.v), b, k0, Skv, KVH, kvh, D);

  // queries that attend some key of this tile: [q_lo, q_hi); key j is
  // attended by i >= j (causal) and i < j + window
  const int last_key = min(k0 + kBlockK, Skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(Sq, last_key + a.window) : Sq;
  const int t_begin = (q_lo / kBlockQ) * kBlockQ;

  float dk[kRows][kCols], dv[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = t_begin; qt < q_hi; qt += kBlockQ) {
      __syncthreads();  // the last tile's q, dO, P, dS are read
      load_tile<T, DMAX>(qs, static_cast<const T*>(a.q), b, qt, Sq, H, h, D);
      load_tile<T, DMAX>(dos, static_cast<const T*>(a.dout), b, qt, Sq, H, h,
                         D);
      if (tid < kBlockQ) {
        const int row = qt + tid;
        const size_t idx = ((size_t)b * H + h) * Sq + row;
        lse_s[tid] = row < Sq ? a.lse[idx] : 0.f;
        delta_s[tid] = row < Sq ? a.delta[idx] : 0.f;
      }
      __syncthreads();

      // scores transposed: keys ty * 4 + i against queries tx + 16 j
      float s[kRows][kOther], dp[kRows][kOther];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOther; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DMAX; ++d) {
        float kv[kRows], vv[kRows], qv[kOther], gv[kOther];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = ks[(ty * kRows + i) * QS + d];
          vv[i] = vs[(ty * kRows + i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < kOther; ++j) {
          qv[j] = qs[(tx + 16 * j) * QS + d];
          gv[j] = dos[(tx + 16 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kOther; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kOther; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f, g2 = 0.f;
          if (attended(a, qt + c, k0 + r)) {
            p = expf(fmaf(s[i][j], scale, -lse_s[c]));
            g2 = p * (dp[i][j] - delta_s[c]);
          }
          ps[r * kPStride + c] = p;
          ds[r * kPStride + c] = g2;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float pv[kRows], gv[kRows], ov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = ps[(ty * kRows + i) * kPStride + qq];
          gv[i] = ds[(ty * kRows + i) * kPStride + qq];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          ov[c] = dos[qq * QS + tx + 16 * c];
          qv[c] = qs[qq * QS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
            dk[i][c] = fmaf(gv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key >= Skv) continue;
    const size_t base = (((size_t)b * Skv + key) * KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dkg + base + d, dk[i][c] * scale);
        store(dvg + base + d, dv[i][c]);
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const FlashAttentionBwdArgs& a, cudaStream_t stream) {
  constexpr size_t tile = (size_t)64 * (DMAX + 1);
  constexpr size_t score = (size_t)64 * kPStride;
  const size_t dq_bytes = (4 * tile + score) * sizeof(float);
  const size_t kv_bytes = (4 * tile + 2 * score) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)a.batch * a.q_len * a.num_heads;
  const unsigned delta_blocks =
      (unsigned)((rows * 32 + kThreads - 1) / kThreads);
  flash_bwd_delta_kernel<T><<<delta_blocks, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((a.q_len + kBlockQ - 1) / kBlockQ, a.num_heads, a.batch);
  flash_bwd_dq_kernel<T, DMAX><<<grid_q, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.kv_size > 0) {
    const dim3 grid_k((a.kv_size + kBlockK - 1) / kBlockK, a.num_kv_heads,
                      a.batch);
    flash_bwd_dkdv_kernel<T, DMAX><<<grid_k, kThreads, kv_bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashAttentionBwdArgs& a, cudaStream_t s) {
  if (a.head_dim <= 16) return launch<T, 16>(a, s);
  if (a.head_dim <= 32) return launch<T, 32>(a, s);
  if (a.head_dim <= 64) return launch<T, 64>(a, s);
  return launch<T, 128>(a, s);
}

}  // namespace

extern "C" {

// Launches the backward pass (three kernels) on `stream`; returns a
// cudaError_t (0 = success).  Head dims above 128, a head count that the
// kv heads do not divide, and negative sizes or window are refused
// (cudaErrorInvalidValue).
int repro_flash_attention_bwd(const FlashAttentionBwdArgs* args,
                              void* stream) {
  const FlashAttentionBwdArgs& a = *args;
  if (a.batch < 0 || a.q_len < 0 || a.kv_size < 0 || a.num_heads < 1 ||
      a.num_kv_heads < 1 || a.num_heads % a.num_kv_heads != 0 ||
      a.head_dim < 1 || a.head_dim > 128 || a.window < 0 ||
      a.num_heads > 65535 || a.batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0 || a.q_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // extern "C"
