// GQA streaming-softmax (flash) attention, forward, bf16, on Hopper's tensor
// cores (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:75, pl.pallas_call at :113) for bf16
// operands whose head dim D is a multiple of 16 up to 128 (Hymba's 64; the
// Whisper and dense configs' 128); fp32 operands and bf16 at other D take
// the SIMT kernel of flash_attention.cu.  Computes what
// `ref_flash_attention` (kernels/ref.py) computes, as that kernel does: q
// (B, Sq, H, D) against k/v (B, Skv, KVH, D), query head h reading kv head
// h / (H / KVH); query row i at position q_offset + i attends key j iff
// j < kv_len, and with `causal` j <= position, with `window` > 0
// j > position - window; scores q.k / sqrt(D) and the softmax in fp32; a
// row that attends no key is written as zeros.
//
// Design.  One block per (query tile, query head, batch row): consumer
// warpgroups of 64 query rows each (three at D <= 64, a 192-row tile; two
// at D > 64), and one producer warp.
// - The producer issues TMA loads: the query tile once, then 64-key K and V
//   tiles of the block's kv head into a ring of stages, each with a full
//   barrier per operand (transaction bytes) and an empty barrier that every
//   consumer thread arrives on once it is done with the stage.  The tensor
//   maps are 4-D over (D, heads, S, B), so a ragged Sq or Skv reads zeros
//   past the end instead of the next batch row, and D < 64 reads zeros in
//   the box's last columns; 128-byte swizzle, 64-column boxes (D = 128
//   takes two), matching the wgmma shared-memory descriptors.
// - S = Q K^T: wgmma m64n64k16, the query tile (K-major) and the key tile
//   (K-major) both from shared memory, fp32 accumulator in registers.
//   bf16 x bf16 products are exact in fp32, so only the summation order
//   differs from the plain version.
// - Mask and the online softmax on the accumulator, in the log2 domain:
//   running max per row (a quad of lanes shares a row), P = 2^(s scale
//   log2(e) - max) as one FMA and one ex2.approx, a masked score exp'd to
//   an exact 0, and the denominator summed from the fp32 P.  Key tiles that no row of a warpgroup attends are
//   skipped (the producer loads only the tiles some row of the block
//   attends; the window's first key comes from the tile's first row); the
//   mask is applied only on tiles that a row's window, causal end or kv_len
//   cuts.
// - O += P V: P is split as P_hi = bf16(P) and P_lo = bf16(P - P_hi), both
//   register A operands (the accumulator layout of the first product maps
//   onto the A fragment of the second), V the B operand from shared memory,
//   MN-major (D is contiguous: the transpose bit).  Two wgmmas into one
//   fp32 accumulator: P V then carries P to about 16 bits, where P rounded
//   once to bf16 would land outputs more than one bf16 ulp from the fp32
//   plain version (tests/test_torch_flash_split.py shows both).
// - Rows past Sq and columns past D are not stored.  With `lse` set (a
//   forward whose backward follows, flash_attention_bwd.cu) each row's
//   log-sum-exp (m + log2 l) ln 2 is stored too, from one lane of its quad.
//
// What bounds it (H100 SXM data sheet: 989 TFLOP/s bf16 dense tensor cores,
// 3.35 TB/s).  At the scoring pass's call, q (2, 4096, 25, 64) against k/v
// (2, 4096, 5, 64) with a 2048 window, the function is 4 D flops on each of
// ~3.1e8 attended pairs, 8.0e10 flops, 0.081 ms on the tensor cores,
// against 63 MB moved (0.019 ms): bound by operations.  The kernel does 1.5x
// that work (the second P V product), plus the masked halves of the
// diagonal and window-edge tiles, and runs each warpgroup's two products
// and its softmax one after the other; the block's warpgroups overlap one's
// products with another's softmax.
#include <cmath>

#include "flash_attention.cuh"
#include "flash_wgmma_common.cuh"

namespace {

constexpr int kBlockK = 64;                    // keys per stage
constexpr int kRowBytes = 128;                 // 64 bf16 columns, swizzled
constexpr uint32_t kKVChunk = kBlockK * kRowBytes;  // 64 columns of a k/v tile

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The tiles of a head dim padded to DP = 64 or 128 (64-column chunks):
// consumer warpgroups (64 query rows each) per block, stages of the K / V
// ring, shared memory.  One block per SM, whose warpgroups share each K / V
// tile and overlap one's products with another's softmax.  At DP = 64
// three warpgroups fit without spills (four, or two blocks of two, leave 96
// registers a thread, and ptxas spills); at DP = 128 the output accumulator
// takes twice the registers, and two fit.
template <int DP>
struct Tiles {
  static constexpr int kConsumers = DP == 64 ? 3 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;      // query rows per block
  static constexpr int kThreads = 128 * kConsumers + 32;  // + the producer
  static constexpr uint32_t kQChunk = kBlockQ * kRowBytes;  // 64 columns of q
  static constexpr int kChunks = DP / 64;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr uint32_t kStageBytes = 2 * kChunks * kKVChunk;  // K, V
  static constexpr size_t kSmemBytes =
      1024 + kChunks * kQChunk + (size_t)kStages * kStageBytes;
};

template <int DP>
__global__ void __launch_bounds__(Tiles<DP>::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const FlashAttentionArgs a) {
  constexpr int kConsumers = Tiles<DP>::kConsumers;
  constexpr int kBlockQ = Tiles<DP>::kBlockQ;
  constexpr uint32_t kQChunk = Tiles<DP>::kQChunk;
  constexpr int kChunks = Tiles<DP>::kChunks;
  constexpr int kStages = Tiles<DP>::kStages;
  constexpr uint32_t kStageBytes = Tiles<DP>::kStageBytes;
  constexpr int kAcc = DP / 2;           // output accumulator, per thread
  constexpr int kKSteps = kBlockK / 16;  // P V steps per tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[kStages], full_v[kStages],
      empty[kStages];
  // tiles on 1024-byte boundaries (the 128-byte swizzle's 8-row atom)
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + kChunks * kQChunk;

  const int Sq = a.q_len, H = a.num_heads, D = a.head_dim;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / a.num_kv_heads);
  const int tid = threadIdx.x;

  // keys that some row of this block attends: [k_lo, k_hi), in tiles from
  // t_begin; producer and consumers walk the same n_tiles
  const int kv_valid = min(a.kv_len, a.kv_size);
  const int pos_first = a.q_offset + q0;
  const int pos_last = a.q_offset + min(q0 + kBlockQ, Sq) - 1;
  int k_lo = 0, k_hi = kv_valid;
  if (a.causal) k_hi = min(k_hi, pos_last + 1);
  if (a.window > 0) k_lo = max(k_lo, pos_first - a.window + 1);
  const int t_begin = (k_lo / kBlockK) * kBlockK;
  const int n_tiles = k_hi > t_begin ? (k_hi - t_begin + kBlockK - 1) / kBlockK
                                     : 0;

  if (tid == 0) {
    mbar_init(smem_u32(&bar_q), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_k[s]), 1);
      mbar_init(smem_u32(&full_v[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {  // the producer warp: one thread loads
    if (tid == 128 * kConsumers) {
      const uint32_t bq = smem_u32(&bar_q);
      mbar_expect_tx(bq, kChunks * kQChunk);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(q_smem + c * kQChunk, &tm_q, bq, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kt = t_begin + i * kBlockK;
        if (i >= kStages) mbar_wait(smem_u32(&empty[s]), ((i / kStages) - 1) & 1);
        const uint32_t k_dst = kv_smem + s * kStageBytes;
        const uint32_t v_dst = k_dst + kChunks * kKVChunk;
        const uint32_t fk = smem_u32(&full_k[s]), fv = smem_u32(&full_v[s]);
        mbar_expect_tx(fk, kChunks * kKVChunk);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(k_dst + c * kKVChunk, &tm_k, fk, 64 * c, kvh, kt, b);
        mbar_expect_tx(fv, kChunks * kKVChunk);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(v_dst + c * kKVChunk, &tm_v, fv, 64 * c, kvh, kt, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r_lo .. r_lo + 63
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = q0 + 64 * wg;
  const int rows = min(64, Sq - r_lo);
  const int p_first = a.q_offset + r_lo, p_last = p_first + rows - 1;
  int wk_lo = 0, wk_hi = rows > 0 ? kv_valid : 0;
  if (a.causal) wk_hi = min(wk_hi, p_last + 1);
  if (a.window > 0) wk_lo = max(wk_lo, p_first - a.window + 1);
  // this thread's two rows (the accumulator layout of m64nNk16: rows row0
  // and row0 + 8) and its columns 8 j + 2 (lane % 4) + {0, 1}; the key
  // tiles every row of the warpgroup attends whole: kt >= full_lo and
  // kt + 64 <= full_hi
  const int row0 = r_lo + 16 * warp + (lane >> 2);
  const int pos0 = a.q_offset + row0;
  const int col = 2 * (lane & 3);
  const int full_hi = a.causal ? min(kv_valid, p_first + 1) : kv_valid;
  const int full_lo = a.window > 0 ? p_last - a.window + 1 : 0;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const int k_steps = D / 16;  // S = Q K^T steps over the head dim

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const uint32_t q_wg = q_smem + wg * 64 * kRowBytes;
  mbar_wait(smem_u32(&bar_q), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, kt = t_begin + i * kBlockK;
    const uint32_t par = (i / kStages) & 1;
    const uint32_t k_tile = kv_smem + s * kStageBytes;
    const uint32_t v_tile = k_tile + kChunks * kKVChunk;
    mbar_wait(smem_u32(&full_k[s]), par);
    if (kt < wk_hi && kt + kBlockK > wk_lo) {
      float sc[kBlockK / 2];
#pragma unroll
      for (int r = 0; r < kBlockK / 2; ++r) sc[r] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks < k_steps) {
          const uint32_t off = (ks % 4) * 32;  // 16 columns, in the chunk
          wgmma_ss_n64(sc,
                       sw128_desc(q_wg + (ks / 4) * kQChunk + off, 16, 1024),
                       sw128_desc(k_tile + (ks / 4) * kKVChunk + off, 16, 1024),
                       ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask where a row's window, causal end or kv_len cuts the tile
      if (kt < full_lo || kt + kBlockK > full_hi) {
        // the keys each row attends, [lo, hi) (recomputed here, from the
        // parameters, to keep registers free in the loop)
        const int kv_end = min(a.kv_len, a.kv_size);
        const int hi0 = a.causal ? min(kv_end, pos0 + 1) : kv_end;
        const int hi1 = a.causal ? min(kv_end, pos0 + 9) : kv_end;
        const int lo0 = a.window > 0 ? pos0 - a.window + 1 : 0;
        const int lo1 = a.window > 0 ? pos0 + 9 - a.window : 0;
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kt + 8 * j + col + e;
            if (key < lo0 || key >= hi0) sc[4 * j + e] = -INFINITY;
            if (key < lo1 || key >= hi1) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      // online softmax in the log2 domain: p = 2^(s scale log2(e) - m)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float n1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      // a row with no key so far keeps p = 0 (2^-inf), corr unused
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = ex2(m0 - u0), c1 = ex2(m1 - u1);
      m0 = n0;
      m1 = n1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -u0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -u0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -u1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -u1));
        rs0 += sc[4 * j] + sc[4 * j + 1];
        rs1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + rs0;  // this thread's share; quads summed at the end
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      // P as A fragments of m64nNk16 (keys 16 kk .. 16 kk + 15): high and
      // low bf16 parts
      uint32_t p_hi[kKSteps][4], p_lo[kKSteps][4];
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p_hi[kk][r] = split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                                   p_lo[kk][r]);

      mbar_wait(smem_u32(&full_v[s]), par);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_rs<DP>(o, p_hi[kk],
                     sw128_desc(v_tile + kk * 16 * kRowBytes, kKVChunk, 1024));
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_rs<DP>(o, p_lo[kk],
                     sw128_desc(v_tile + kk * 16 * kRowBytes, kKVChunk, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    } else {
      mbar_wait(smem_u32(&full_v[s]), par);  // the stage's loads are done
    }
    mbar_arrive(smem_u32(&empty[s]));
  }

  // out = o / l; a row that attended no key has o = 0 and l = 0: zeros
  const float s0 = quad_sum(l0), s1 = quad_sum(l1);
  const float d0 = fmaxf(s0, 1e-30f), d1 = fmaxf(s1, 1e-30f);
  if (a.lse != nullptr && (lane & 3) == 0) {
    // log-sum-exp in natural units: ln(2^m l) = (m + log2 l) ln 2
    float* lse = a.lse + ((size_t)b * H + h) * Sq;
    if (row0 < Sq)
      lse[row0] = s0 > 0.f ? (m0 + log2f(s0)) * 0.6931471805599453f
                           : -INFINITY;
    if (row0 + 8 < Sq)
      lse[row0 + 8] = s1 > 0.f ? (m1 + log2f(s1)) * 0.6931471805599453f
                               : -INFINITY;
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out);
  const size_t stride_row = (size_t)H * D;
  __nv_bfloat16* out0 = og + ((size_t)b * Sq + row0) * stride_row + (size_t)h * D;
  __nv_bfloat16* out1 = out0 + 8 * stride_row;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int c = 8 * j + col;
    if (c < D) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out0 + c) =
            __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out1 + c) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

template <int DP>
int launch(const FlashAttentionArgs& a, cudaStream_t stream) {
  const size_t bytes = Tiles<DP>::kSmemBytes;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // with no keys (Skv = 0) no tile is loaded: the k and v maps then
  // describe q's memory, which is never read through them
  const bool keys = a.kv_size > 0;
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, a.q, a.head_dim, a.num_heads, a.q_len, a.batch,
                  Tiles<DP>::kBlockQ) ||
      !encode_map(encode, &tk, keys ? a.k : a.q, a.head_dim,
                  keys ? a.num_kv_heads : a.num_heads,
                  keys ? a.kv_size : a.q_len, a.batch, kBlockK) ||
      !encode_map(encode, &tv, keys ? a.v : a.q, a.head_dim,
                  keys ? a.num_kv_heads : a.num_heads,
                  keys ? a.kv_size : a.q_len, a.batch, kBlockK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBlockQ = Tiles<DP>::kBlockQ;
  const dim3 grid((a.q_len + kBlockQ - 1) / kBlockQ, a.num_heads, a.batch);
  flash_attention_wgmma_kernel<DP>
      <<<grid, Tiles<DP>::kThreads, bytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one bf16 attention pass on the tensor cores on `stream`; returns
// a cudaError_t (0 = success).  Takes bf16 operands whose head dim is a
// multiple of 16 up to 128, on 16-byte boundaries (what the TMA maps take);
// anything else is refused (cudaErrorInvalidValue), as are a head count
// that the kv heads do not divide and negative sizes, window or kv_len.
int repro_flash_attention_wgmma(const FlashAttentionArgs* args, void* stream) {
  const FlashAttentionArgs& a = *args;
  if (!a.bf16 || a.batch < 0 || a.q_len < 0 || a.kv_size < 0 ||
      a.num_heads < 1 || a.num_kv_heads < 1 ||
      a.num_heads % a.num_kv_heads != 0 || a.head_dim < 16 ||
      a.head_dim > 128 || a.head_dim % 16 != 0 || a.kv_len < 0 ||
      a.window < 0 || a.num_heads > 65535 || a.batch > 65535 ||
      (reinterpret_cast<uintptr_t>(a.q) & 15) ||
      (a.kv_size > 0 && ((reinterpret_cast<uintptr_t>(a.k) & 15) ||
                          (reinterpret_cast<uintptr_t>(a.v) & 15))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0 || a.q_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.head_dim <= 64 ? launch<64>(a, s) : launch<128>(a, s);
}

}  // extern "C"
