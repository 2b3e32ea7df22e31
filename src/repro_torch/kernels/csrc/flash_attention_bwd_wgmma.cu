// GQA streaming-softmax (flash) attention, backward, bf16, on Hopper's tensor
// cores (sm_90a: wgmma, TMA, mbarriers): the "wgmma" route of
// `ops.flash_attention_backward` (`ops.flash_bwd_route`: bf16 with a head
// dim D that is a multiple of 16 up to 128; fp32 and other D take the SIMT
// kernel of flash_attention_bwd.cu).
//
// Replaces JAX's autodiff of the jnp layer `repro.models.layers.
// flash_attention` (src/repro/models/layers.py:94), which the TPU package
// differentiates when it trains; the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:75) has no backward of its own.
// Computes what `ref_flash_attention_bwd` (kernels/ref.py) computes: from
// q (B, Sq, H, D), k/v (B, Skv, KVH, D), the forward's output `out` and
// row log-sum-exp `lse` (B, H, Sq) and the cotangent `dout`,
//   P = exp(q.k / sqrt(D) - lse) on the attended keys, 0 elsewhere,
//   Delta_i = dO_i . out_i,  dS = P (dO_i . v_j - Delta_i),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),  dV = P^T dO,
// dK and dV summed over each kv head's group of query heads, with the
// forward's mask (query row i attends key j iff j < Skv, with `causal`
// j <= i, with `window` > 0 j > i - window).
//
// Design (FlashAttention-2's backward in two passes, FlashAttention-3's
// pieces: the forward kernel's TMA maps, ring of stages and producer warp).
// Three launches on the stream, no atomics (a repeated call is bitwise
// equal):
//   1. prep: one warp per (b, h, query row) up to Sq rounded to 64: Delta
//      in fp32, and lse in log2 units, +inf past Sq and where lse = -inf
//      (a row that attends no key): every P of such a row is 2^-inf = 0;
//   2. dq: one block per (query tile, query head, batch row), consumer
//      warpgroups of 64 rows (three at D <= 64, two at D = 128, where the
//      dQ accumulator takes twice the registers) and a producer warp.  The
//      tile's q
//      and dO stay in shared memory; 64-key K and V tiles stream through a
//      ring of stages (only the tiles some row attends).  S = Q K^T and
//      dP = dO V^T are two wgmma m64n64k16 products from shared memory
//      (bf16 operands: exact products, fp32 sums); P = 2^(s scale log2 e -
//      lse2) and dS = P (dP - Delta) in fp32 on the accumulators; dQ += dS
//      K with dS as register A operands and K MN-major from shared memory;
//   3. dkdv: one block per (64 NC-key tile, kv head, batch row), NC = 2
//      consumer warpgroups of 64 keys at D <= 64 (1 at D = 128: the dK and
//      dV accumulators of 64 keys are 2 x 64 x 128 fp32, 128 registers a
//      thread) and a producer warp.  K and V stay in shared memory; the
//      producer streams Q, dO and each tile's lse2 and Delta (a bulk copy)
//      for every query head of the group and every 64-row query tile that
//      attends the key tile.  S^T = K Q^T and dP^T = V dO^T from shared
//      memory, P^T and dS^T on the accumulators, dV += P^T dO and dK +=
//      dS^T Q with P^T and dS^T as register operands and dO and Q
//      MN-major.  The group's sum is formed in one block in a fixed order.
// P and dS are fp32; each goes into its product as hi = bf16(x) and lo =
// bf16(x - hi), two wgmmas into one accumulator, which carries them to
// about 16 bits: one bf16 rounding of either lands gradients more than one
// bf16 ulp from the fp32 plain version (tests/test_torch_flash_bwd_split.py
// emulates both).  Masks are applied only on tiles that the causal bound,
// the window or Skv cuts; TMA reads zeros past Sq, Skv and D; rows past Sq
// or Skv and columns past D are not stored.
//
// What bounds it (H100 SXM data sheet: 989 TFLOP/s bf16 dense tensor
// cores, 3.35 TB/s).  The function is 5 products of 2 D flops on each
// attended pair (S, dP, dV, dK, dQ); at Hymba's training call, q (2, 4096,
// 25, 64) against k/v (2, 4096, 5, 64) with a 2048 window, 2.0e11 flops,
// 0.20 ms on the tensor cores, against ~130 MB moved: bound by operations.
// The kernel does 9 products a pair (S and dP twice, one per pass; dV, dK
// and dQ twice, the split), plus the masked parts of the diagonal and
// window-edge tiles, and each warpgroup runs its products and its
// elementwise work one after the other (warpgroups of one block, and two
// blocks' where registers allow, overlap them).
#include <cmath>

#include "flash_attention_bwd.cuh"
#include "flash_wgmma_common.cuh"

namespace {

constexpr int kTile = 64;                      // rows of a streamed tile
constexpr int kRowBytes = 128;                 // 64 bf16 columns, swizzled
constexpr uint32_t kChunk64 = kTile * kRowBytes;  // 64 columns of a tile
constexpr float kLog2e = 1.4426950408889634f;

// d (64 x 64) = a (64 x D) b^T (D x 64): a and b tiles in shared memory,
// both K-major (D contiguous) in 64-column chunks `a_chunk` / `b_chunk`
// bytes apart; D / 16 steps.
template <int DP>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a,
                                       uint32_t a_chunk, uint32_t b,
                                       uint32_t b_chunk, int k_steps) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if (ks < k_steps) {
      const uint32_t off = (ks % 4) * 32;  // 16 columns, in the chunk
      wgmma_ss_n64(d, sw128_desc(a + (ks / 4) * a_chunk + off, 16, 1024),
                   sw128_desc(b + (ks / 4) * b_chunk + off, 16, 1024),
                   ks > 0);
    }
  }
}

// A 64 x 64 fp32 accumulator as the A fragments of four m64nNk16 steps
// (columns 16 kk .. 16 kk + 15), high and low bf16 parts.
__device__ __forceinline__ void acc_frags(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hi[kk][r] = split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1],
                             lo[kk][r]);
}

// d += A B over 64 rows of K: A the split fragments, B a 64-row tile in
// shared memory, MN-major (its D columns contiguous, 64-column chunks
// `b_chunk` bytes apart).
template <int DP>
__device__ __forceinline__ void accumulate_split(float (&d)[DP / 2],
                                                 const uint32_t (&hi)[4][4],
                                                 const uint32_t (&lo)[4][4],
                                                 uint32_t b, uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP>(d, hi[kk], sw128_desc(b + kk * 16 * kRowBytes, b_chunk, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP>(d, lo[kk], sw128_desc(b + kk * 16 * kRowBytes, b_chunk, 1024));
}

// Stores a 64-row accumulator tile (D columns) in bf16, times `scale`:
// rows row0 and row0 + 8 of this thread (below `n_rows` of the tensor),
// `stride` elements apart.
template <int DP>
__device__ __forceinline__ void store_tile(const float (&d)[DP / 2],
                                           __nv_bfloat16* base, int row0,
                                           int n_rows, size_t stride, int D,
                                           float scale) {
  const int col = 2 * (threadIdx.x & 3);
  __nv_bfloat16* p0 = base + (size_t)row0 * stride;
  __nv_bfloat16* p1 = p0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + col;
    if (c < D) {
      if (row0 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(p0 + c) =
            __floats2bfloat162_rn(d[4 * j] * scale, d[4 * j + 1] * scale);
      if (row0 + 8 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(p1 + c) = __floats2bfloat162_rn(
            d[4 * j + 2] * scale, d[4 * j + 3] * scale);
    }
  }
}

__host__ __device__ __forceinline__ int padded_rows(int Sq) {
  return (Sq + kTile - 1) / kTile * kTile;
}

// ---- 1. prep: Delta and lse in log2 units -----------------------------------

constexpr int kPrepThreads = 256;

__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_wgmma_prep_kernel(const FlashAttentionBwdArgs a) {
  const int H = a.num_heads, Sq = a.q_len, D = a.head_dim;
  const int Sp = padded_rows(Sq);
  const long long row =
      ((long long)blockIdx.x * kPrepThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.batch * H * Sp;
  if (row >= rows) return;  // the whole warp
  // row walks (b, h, i) with i fastest
  const int i = (int)(row % Sp);
  const long long bh = row / Sp;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float s = 0.f;
  if (i < Sq) {
    const size_t off = (((size_t)b * Sq + i) * H + h) * D;
    const __nv_bfloat162* o =
        reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(a.out) + off);
    const __nv_bfloat162* g =
        reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(a.dout) + off);
    for (int d = lane; d < D / 2; d += 32) {
      const float2 x = __bfloat1622float2(o[d]), y = __bfloat1622float2(g[d]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    float l2 = INFINITY;
    if (i < Sq) {
      const float l = a.lse[(size_t)bh * Sq + i];
      if (l > -INFINITY) l2 = l * kLog2e;
    }
    a.delta[row] = s;
    a.delta[rows + row] = l2;
  }
}

// ---- 2. dq ------------------------------------------------------------------

// dq blocks: consumer warpgroups of 64 query rows (three at DP = 64, as
// the forward; two at DP = 128, where the dQ accumulator takes twice the
// registers) and the producer warp; q and dO resident, K / V stages.  DP =
// D padded to 64 or 128.
template <int DP>
struct DqTiles {
  static constexpr int kConsumers = DP == 64 ? 3 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kChunks = DP / 64;
  static constexpr uint32_t kQChunk = kBlockQ * kRowBytes;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr uint32_t kStageBytes = 2 * kChunks * kChunk64;  // K, V
  static constexpr size_t kSmemBytes =
      1024 + 2 * kChunks * kQChunk + (size_t)kStages * kStageBytes;
};

template <int DP>
__global__ void __launch_bounds__(DqTiles<DP>::kThreads, 1)
    flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const FlashAttentionBwdArgs a) {
  using T = DqTiles<DP>;
  constexpr int kStages = T::kStages, kChunks = T::kChunks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[kStages], full_v[kStages],
      empty[kStages];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_smem = q_smem + kChunks * T::kQChunk;
  const uint32_t kv_smem = do_smem + kChunks * T::kQChunk;

  const int Sq = a.q_len, Skv = a.kv_size, H = a.num_heads, D = a.head_dim;
  const int q0 = blockIdx.x * T::kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / a.num_kv_heads);
  const int tid = threadIdx.x;

  // keys some row of the block attends: tiles from t_begin, n_tiles of them
  const int pos_last = min(q0 + T::kBlockQ, Sq) - 1;
  int k_lo = 0, k_hi = Skv;
  if (a.causal) k_hi = min(k_hi, pos_last + 1);
  if (a.window > 0) k_lo = max(k_lo, q0 - a.window + 1);
  const int t_begin = (k_lo / kTile) * kTile;
  const int n_tiles = k_hi > t_begin ? (k_hi - t_begin + kTile - 1) / kTile : 0;

  if (tid == 0) {
    mbar_init(smem_u32(&bar_q), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_k[s]), 1);
      mbar_init(smem_u32(&full_v[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * T::kConsumers) {  // the producer warp: one thread loads
    if (tid == 128 * T::kConsumers) {
      const uint32_t bq = smem_u32(&bar_q);
      mbar_expect_tx(bq, 2 * kChunks * T::kQChunk);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(q_smem + c * T::kQChunk, &tm_q, bq, 64 * c, h, q0, b);
        tma_load_4d(do_smem + c * T::kQChunk, &tm_do, bq, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kt = t_begin + i * kTile;
        if (i >= kStages) mbar_wait(smem_u32(&empty[s]), ((i / kStages) - 1) & 1);
        const uint32_t k_dst = kv_smem + s * T::kStageBytes;
        const uint32_t v_dst = k_dst + kChunks * kChunk64;
        const uint32_t fk = smem_u32(&full_k[s]), fv = smem_u32(&full_v[s]);
        mbar_expect_tx(fk, kChunks * kChunk64);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(k_dst + c * kChunk64, &tm_k, fk, 64 * c, kvh, kt, b);
        mbar_expect_tx(fv, kChunks * kChunk64);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(v_dst + c * kChunk64, &tm_v, fv, 64 * c, kvh, kt, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r_lo .. r_lo + 63
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = q0 + 64 * wg;
  const int rows = min(64, Sq - r_lo);
  const int p_first = r_lo, p_last = p_first + rows - 1;
  int wk_lo = 0, wk_hi = rows > 0 ? Skv : 0;
  if (a.causal) wk_hi = min(wk_hi, p_last + 1);
  if (a.window > 0) wk_lo = max(wk_lo, p_first - a.window + 1);
  // this thread's rows row0 and row0 + 8, columns 8 j + col + {0, 1}; key
  // tiles every row of the warpgroup attends whole: kt >= full_lo and
  // kt + 64 <= full_hi
  const int row0 = r_lo + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  const int full_hi = a.causal ? min(Skv, p_first + 1) : Skv;
  const int full_lo = a.window > 0 ? p_last - a.window + 1 : 0;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const int k_steps = D / 16;
  const size_t bh = (size_t)b * H + h;
  const size_t rows_all = (size_t)a.batch * H * padded_rows(Sq);
  const float* delta = a.delta + bh * padded_rows(Sq);
  const float* lse2 = a.delta + rows_all + bh * padded_rows(Sq);
  const float l0 = row0 < Sq ? lse2[row0] : INFINITY;
  const float l1 = row0 + 8 < Sq ? lse2[row0 + 8] : INFINITY;
  const float dl0 = row0 < Sq ? delta[row0] : 0.f;
  const float dl1 = row0 + 8 < Sq ? delta[row0 + 8] : 0.f;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  const uint32_t q_wg = q_smem + wg * 64 * kRowBytes;
  const uint32_t do_wg = do_smem + wg * 64 * kRowBytes;
  mbar_wait(smem_u32(&bar_q), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, kt = t_begin + i * kTile;
    const uint32_t par = (i / kStages) & 1;
    const uint32_t k_tile = kv_smem + s * T::kStageBytes;
    const uint32_t v_tile = k_tile + kChunks * kChunk64;
    mbar_wait(smem_u32(&full_k[s]), par);
    if (kt < wk_hi && kt + kTile > wk_lo) {
      float sc[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = dp[r] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      scores<DP>(sc, q_wg, T::kQChunk, k_tile, kChunk64, k_steps);
      wgmma_commit();
      mbar_wait(smem_u32(&full_v[s]), par);
      scores<DP>(dp, do_wg, T::kQChunk, v_tile, kChunk64, k_steps);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = kt < full_lo || kt + kTile > full_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(sc[4 * j + e], scale_log2, -l0));
          float p1 = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -l1));
          if (edge) {
            const int key = kt + 8 * j + col + e;
            const bool in = key < Skv;
            if (!in || (a.causal && key > row0) ||
                (a.window > 0 && key <= row0 - a.window))
              p0 = 0.f;
            if (!in || (a.causal && key > row0 + 8) ||
                (a.window > 0 && key <= row0 + 8 - a.window))
              p1 = 0.f;
          }
          dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
          dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
        }
      }
      uint32_t ds_hi[4][4], ds_lo[4][4];
      acc_frags(dp, ds_hi, ds_lo);
      fence_regs(dq);
      wgmma_fence();
      accumulate_split<DP>(dq, ds_hi, ds_lo, k_tile, kChunk64);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
    } else {
      mbar_wait(smem_u32(&full_v[s]), par);  // the stage's loads are done
    }
    mbar_arrive(smem_u32(&empty[s]));
  }

  const size_t stride = (size_t)H * D;
  store_tile<DP>(dq,
                 static_cast<__nv_bfloat16*>(a.dq) + (size_t)b * Sq * stride +
                     (size_t)h * D,
                 row0, Sq, stride, D, 1.0f / sqrtf((float)D));
}

// ---- 3. dk, dv ---------------------------------------------------------------

// dkdv blocks: NC consumer warpgroups (64 keys each) and the producer warp;
// K and V resident, stages of Q, dO and the tile's lse2 and Delta.
template <int DP>
struct DkvTiles {
  static constexpr int kConsumers = DP == 64 ? 2 : 1;
  static constexpr int kBlockK = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kChunks = DP / 64;
  static constexpr uint32_t kKChunk = kBlockK * kRowBytes;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  // Q, dO, then lse2 and Delta (2 x 64 floats, padded to 1024 bytes)
  static constexpr uint32_t kTileBytes = kChunks * kChunk64;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + 1024;
  static constexpr size_t kSmemBytes =
      1024 + 2 * kChunks * kKChunk + (size_t)kStages * kStageBytes;
};

template <int DP>
__global__ void __launch_bounds__(DkvTiles<DP>::kThreads, 1)
    flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const FlashAttentionBwdArgs a) {
  using T = DkvTiles<DP>;
  constexpr int kStages = T::kStages, kChunks = T::kChunks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[kStages], empty[kStages];
  const uint32_t k_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + kChunks * T::kKChunk;
  const uint32_t st_smem = v_smem + kChunks * T::kKChunk;
  // the generic address of the stages, for the consumers' lse2 / Delta
  const uint8_t* st_generic = smem_raw + (st_smem - smem_u32(smem_raw));

  const int Sq = a.q_len, Skv = a.kv_size, H = a.num_heads, D = a.head_dim;
  const int KVH = a.num_kv_heads, G = H / KVH;
  const int k0 = blockIdx.x * T::kBlockK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Sp = padded_rows(Sq);
  const size_t rows_all = (size_t)a.batch * H * Sp;

  // query tiles that attend some key of the block: key j is attended by
  // queries i >= j (causal) and i < j + window
  const int last_key = min(k0 + T::kBlockK, Skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(Sq, last_key + a.window) : Sq;
  const int t_begin = (q_lo / kTile) * kTile;
  const int n_qt = q_hi > t_begin ? (q_hi - t_begin + kTile - 1) / kTile : 0;
  const int n_tiles = G * n_qt;

  if (tid == 0) {
    mbar_init(smem_u32(&bar_kv), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * T::kConsumers) {  // the producer warp: one thread loads
    if (tid == 128 * T::kConsumers) {
      const uint32_t bkv = smem_u32(&bar_kv);
      mbar_expect_tx(bkv, 2 * kChunks * T::kKChunk);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(k_smem + c * T::kKChunk, &tm_k, bkv, 64 * c, kvh, k0, b);
        tma_load_4d(v_smem + c * T::kKChunk, &tm_v, bkv, 64 * c, kvh, k0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, g = i / n_qt;
        const int qt = t_begin + (i % n_qt) * kTile, h = kvh * G + g;
        if (i >= kStages) mbar_wait(smem_u32(&empty[s]), ((i / kStages) - 1) & 1);
        const uint32_t q_dst = st_smem + s * T::kStageBytes;
        const uint32_t do_dst = q_dst + T::kTileBytes;
        const uint32_t ls_dst = do_dst + T::kTileBytes;
        const uint32_t f = smem_u32(&full[s]);
        mbar_expect_tx(f, 2 * T::kTileBytes + 2 * kTile * sizeof(float));
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(q_dst + c * kChunk64, &tm_q, f, 64 * c, h, qt, b);
          tma_load_4d(do_dst + c * kChunk64, &tm_do, f, 64 * c, h, qt, b);
        }
        const size_t row = ((size_t)b * H + h) * Sp + qt;
        bulk_load(ls_dst, a.delta + rows_all + row, kTile * sizeof(float), f);
        bulk_load(ls_dst + kTile * sizeof(float), a.delta + row,
                  kTile * sizeof(float), f);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys wk0 .. wk0 + 63
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wk0 = k0 + 64 * wg;
  const int wlast = min(wk0 + 64, Skv) - 1;
  const int wq_lo = a.causal ? wk0 : 0;
  const int wq_hi = wk0 >= Skv ? 0
                               : a.window > 0 ? min(Sq, wlast + a.window) : Sq;
  // this thread's keys key0 and key0 + 8, queries 8 j + col + {0, 1}
  const int key0 = wk0 + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const int k_steps = D / 16;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_wg = k_smem + wg * 64 * kRowBytes;
  const uint32_t v_wg = v_smem + wg * 64 * kRowBytes;
  mbar_wait(smem_u32(&bar_kv), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, qt = t_begin + (i % n_qt) * kTile;
    const uint32_t par = (i / kStages) & 1;
    const uint32_t q_tile = st_smem + s * T::kStageBytes;
    const uint32_t do_tile = q_tile + T::kTileBytes;
    mbar_wait(smem_u32(&full[s]), par);
    if (qt < wq_hi && qt + kTile > wq_lo) {
      float st[32], dpt[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) st[r] = dpt[r] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      scores<DP>(st, k_wg, T::kKChunk, q_tile, kChunk64, k_steps);
      scores<DP>(dpt, v_wg, T::kKChunk, do_tile, kChunk64, k_steps);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* ls = reinterpret_cast<const float*>(
          st_generic + s * T::kStageBytes + 2 * T::kTileBytes);
      const float* dl = ls + kTile;
      // a masked pair in the tile: some query before a key (causal), or a
      // key at or past a query's window
      const bool edge = (a.causal && qt < wk0 + 63) ||
                        (a.window > 0 && qt + 63 - wk0 >= a.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col + e;
          const float l = ls[c], dd = dl[c];
          float p0 = ex2(fmaf(st[4 * j + e], scale_log2, -l));
          float p1 = ex2(fmaf(st[4 * j + 2 + e], scale_log2, -l));
          if (edge) {
            const int query = qt + c;
            if ((a.causal && key0 > query) ||
                (a.window > 0 && key0 <= query - a.window))
              p0 = 0.f;
            if ((a.causal && key0 + 8 > query) ||
                (a.window > 0 && key0 + 8 <= query - a.window))
              p1 = 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dd);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dd);
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      acc_frags(st, p_hi, p_lo);
      acc_frags(dpt, ds_hi, ds_lo);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      accumulate_split<DP>(dv, p_hi, p_lo, do_tile, kChunk64);
      accumulate_split<DP>(dk, ds_hi, ds_lo, q_tile, kChunk64);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(smem_u32(&empty[s]));
  }

  const size_t stride = (size_t)KVH * D;
  const size_t base = (size_t)b * Skv * stride + (size_t)kvh * D;
  store_tile<DP>(dk, static_cast<__nv_bfloat16*>(a.dk) + base, key0, Skv,
                 stride, D, 1.0f / sqrtf((float)D));
  store_tile<DP>(dv, static_cast<__nv_bfloat16*>(a.dv) + base, key0, Skv,
                 stride, D, 1.0f);
}

template <int DP>
int launch(const FlashAttentionBwdArgs& a, cudaStream_t stream) {
  using Q = DqTiles<DP>;
  using K = DkvTiles<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_wgmma_dq_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_wgmma_dkdv_kernel<DP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)K::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attrs = true;
  }
  const int B = a.batch, Sq = a.q_len, H = a.num_heads, D = a.head_dim;
  // with no keys (Skv = 0) no K / V tile is loaded: their maps then
  // describe q's memory, which is never read through them
  const bool keys = a.kv_size > 0;
  const void* kp = keys ? a.k : a.q;
  const void* vp = keys ? a.v : a.q;
  const int kvh = keys ? a.num_kv_heads : H, skv = keys ? a.kv_size : Sq;
  CUtensorMap q_res, do_res, k_str, v_str, k_res, v_res, q_str, do_str;
  if (!encode_map(encode, &q_res, a.q, D, H, Sq, B, Q::kBlockQ) ||
      !encode_map(encode, &do_res, a.dout, D, H, Sq, B, Q::kBlockQ) ||
      !encode_map(encode, &k_str, kp, D, kvh, skv, B, kTile) ||
      !encode_map(encode, &v_str, vp, D, kvh, skv, B, kTile) ||
      !encode_map(encode, &k_res, kp, D, kvh, skv, B, K::kBlockK) ||
      !encode_map(encode, &v_res, vp, D, kvh, skv, B, K::kBlockK) ||
      !encode_map(encode, &q_str, a.q, D, H, Sq, B, kTile) ||
      !encode_map(encode, &do_str, a.dout, D, H, Sq, B, kTile))
    return (int)cudaErrorInvalidValue;

  const long long rows = (long long)B * H * padded_rows(Sq);
  const unsigned prep_blocks =
      (unsigned)((rows * 32 + kPrepThreads - 1) / kPrepThreads);
  flash_bwd_wgmma_prep_kernel<<<prep_blocks, kPrepThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Sq + Q::kBlockQ - 1) / Q::kBlockQ, H, B);
  flash_bwd_wgmma_dq_kernel<DP><<<grid_q, Q::kThreads, Q::kSmemBytes, stream>>>(
      q_res, do_res, k_str, v_str, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !keys) return (int)err;
  const dim3 grid_k((a.kv_size + K::kBlockK - 1) / K::kBlockK, a.num_kv_heads,
                    B);
  flash_bwd_wgmma_dkdv_kernel<DP>
      <<<grid_k, K::kThreads, K::kSmemBytes, stream>>>(k_res, v_res, q_str,
                                                       do_str, a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches the tensor-core backward pass (three kernels) on `stream`;
// returns a cudaError_t (0 = success).  Takes bf16 operands whose head dim
// is a multiple of 16 up to 128, q, k, v, dout and the scratch on 16-byte
// boundaries (what TMA takes); anything else is refused
// (cudaErrorInvalidValue), as are a head count that the kv heads do not
// divide and negative sizes or window.
int repro_flash_attention_bwd_wgmma(const FlashAttentionBwdArgs* args,
                                    void* stream) {
  const FlashAttentionBwdArgs& a = *args;
  if (!a.bf16 || a.batch < 0 || a.q_len < 0 || a.kv_size < 0 ||
      a.num_heads < 1 || a.num_kv_heads < 1 ||
      a.num_heads % a.num_kv_heads != 0 || a.head_dim < 16 ||
      a.head_dim > 128 || a.head_dim % 16 != 0 || a.window < 0 ||
      a.num_heads > 65535 || a.batch > 65535 || !aligned16(a.q) ||
      !aligned16(a.dout) || !aligned16(a.delta) ||
      (a.kv_size > 0 && (!aligned16(a.k) || !aligned16(a.v))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0 || a.q_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.head_dim <= 64 ? launch<64>(a, s) : launch<128>(a, s);
}

}  // extern "C"
