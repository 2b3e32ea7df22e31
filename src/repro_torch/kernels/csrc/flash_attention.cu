// GQA streaming-softmax (flash) attention, forward, for Hopper (sm_90a), on
// the fp32 cores.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:75, pl.pallas_call at :113), and the
// model's jnp form `repro.models.layers.flash_attention` (:94), for fp32
// operands and for bf16 at head dims that are not a multiple of 16 (bf16 at
// D = 16, 32, .., 128 takes the tensor-core kernel of
// flash_attention_wgmma.cu; `ops.flash_route` picks).  Computes what
// `ref_flash_attention` (kernels/ref.py) computes: q (B, Sq, H, D) against
// k/v (B, Skv, KVH, D), query head h reading kv head h / (H / KVH); query
// row i sits at position q_offset + i and key j at j; key j is attended iff
// j < kv_len, and with `causal` j <= that position, with `window` > 0
// j > position - window.  Scores q.k * (1 / sqrt(D)) and the softmax are
// fp32; the output is in q's dtype (fp32 or bf16).  A row that attends no
// key is written as zeros.  With `lse` set (a forward whose backward
// follows) each row's log-sum-exp m + log(l) is written too.
//
// Design.  One block of 256 threads per (64-row query tile, query head,
// batch row).  The block keeps its query tile in shared memory (fp32) and
// streams 64-key K and V tiles of its kv head through shared memory.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3: it
// scores keys tx + 16 j (j < 4) of each tile, and accumulates output
// columns tx + 16 c (c < D / 16).  The 16 threads of a row group are one
// half-warp, so the running max m, the denominator l and the rescale of the
// fp32 accumulator are half-warp shuffles, with no shared-memory round trip;
// the tile's probabilities go through shared memory once for the P V
// product.  A masked score is exp'd to an exact 0 (not exp(-1e30 - m) as the
// Pallas kernel does), so a masked key never contributes and a key tile that
// no row of the query tile attends is skipped: the loop runs only over the
// tiles between the window's first key and the causal / kv_len end.  The
// result is then the softmax over each row's attended keys, whatever the
// tiling, which is what the Pallas kernel and the jnp layer give for every
// row that attends at least one key (every row on the causal path; their
// -1e30 terms are wiped by the rescale once a valid key arrives).  Ragged
// Sq / Skv are masked in the loads (zero-filled) and the store, so any
// shape works, and any head dim up to 128 (padded to 16, 32, 64 or 128).
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s; 67 TFLOP/s fp32 outside
// the tensor cores).  The fp32 call at the scoring pass's geometry, q
// (2, 4096, 25, 64) against k/v (2, 4096, 5, 64) with a 2048 window, does
// 4 D flops on each of ~3.1e8 attended (query, key) pairs: 8e10 flops, about
// 1.2 ms on the fp32 cores, against 126 MB moved (0.04 ms): it is bound by
// operations.  The kernel runs its products from shared memory (about two
// shared loads per FMA), so it sits well above that bound (PERF.md, §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "flash_attention.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // 16 row groups x 16 lanes
constexpr int kRows = 4;          // query rows per thread
constexpr int kKeys = kBlockK / 16;  // keys per thread per tile
constexpr int kPStride = kBlockK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared memory, in floats: q tile, k tile (rows padded by one against bank
// conflicts), v tile, probabilities
template <int DMAX>
constexpr size_t smem_floats() {
  return (size_t)kBlockQ * (DMAX + 1) + (size_t)kBlockK * (DMAX + 1) +
         (size_t)kBlockK * DMAX + (size_t)kBlockQ * kPStride;
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const FlashAttentionArgs a) {
  constexpr int QS = DMAX + 1;
  constexpr int kCols = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // kBlockQ x QS
  float* ks = qs + kBlockQ * QS;      // kBlockK x QS
  float* vs = ks + kBlockK * QS;      // kBlockK x DMAX
  float* ps = vs + kBlockK * DMAX;    // kBlockQ x kPStride

  const int Sq = a.q_len, Skv = a.kv_size, H = a.num_heads, D = a.head_dim;
  const int KVH = a.num_kv_heads;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf((float)D);

  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  T* og = static_cast<T*>(a.out);

  for (int i = tid; i < kBlockQ * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX, row = q0 + r;
    qs[r * QS + d] =
        (row < Sq && d < D)
            ? to_f32(qg[(((size_t)b * Sq + row) * H + h) * D + d])
            : 0.f;
  }

  // keys that some row of this tile may attend: [k_lo, k_hi)
  const int kv_valid = min(a.kv_len, Skv);
  const int pos_first = a.q_offset + q0;
  const int pos_last = a.q_offset + min(q0 + kBlockQ, Sq) - 1;
  int k_lo = 0, k_hi = kv_valid;
  if (a.causal) k_hi = min(k_hi, pos_last + 1);
  if (a.window > 0) k_lo = max(k_lo, pos_first - a.window + 1);
  const int t_begin = (k_lo / kBlockK) * kBlockK;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = t_begin; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // the last tile's k, v, p are read (and q is stored)
    for (int i = tid; i < kBlockK * DMAX; i += kThreads) {
      const int r = i / DMAX, d = i % DMAX, key = kt + r;
      const bool in = key < Skv && d < D;
      const size_t src = (((size_t)b * Skv + key) * KVH + kvh) * D + d;
      ks[r * QS + d] = in ? to_f32(kg[src]) : 0.f;
      vs[r * DMAX + d] = in ? to_f32(vg[src]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = a.q_offset + q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = kt + tx + 16 * j;
        const bool ok = key < kv_valid && (!a.causal || key <= pos) &&
                        (a.window <= 0 || key > pos - a.window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float corr = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {  // else no key of this row so far: p = 0
        corr = expf(m[i] - m_new);  // 0 when m was -inf
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = expf(s[i][j] - m_new);  // exactly 0 where masked
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        ps[(ty * kRows + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = ps[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    if (a.lse != nullptr && tx == 0)
      a.lse[((size_t)b * H + h) * Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = og + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(orow + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const FlashAttentionArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_floats<DMAX>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.q_len + kBlockQ - 1) / kBlockQ, a.num_heads, a.batch);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashAttentionArgs& a, cudaStream_t s) {
  if (a.head_dim <= 16) return launch<T, 16>(a, s);
  if (a.head_dim <= 32) return launch<T, 32>(a, s);
  if (a.head_dim <= 64) return launch<T, 64>(a, s);
  return launch<T, 128>(a, s);
}

}  // namespace

extern "C" {

// Launches one attention pass on `stream`; returns a cudaError_t (0 =
// success).  Head dims above 128, a head count that the kv heads do not
// divide, and negative sizes or kv_len are refused (cudaErrorInvalidValue).
int repro_flash_attention(const FlashAttentionArgs* args, void* stream) {
  const FlashAttentionArgs& a = *args;
  if (a.batch < 0 || a.q_len < 0 || a.kv_size < 0 || a.num_heads < 1 ||
      a.num_kv_heads < 1 || a.num_heads % a.num_kv_heads != 0 ||
      a.head_dim < 1 || a.head_dim > 128 || a.kv_len < 0 || a.window < 0 ||
      a.num_heads > 65535 || a.batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0 || a.q_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // extern "C"
