// The RWKV6 wkv recurrence, chunk-parallel on Hopper's tensor cores
// (sm_90a, mma.sync m16n8k16 bf16): the "chunk" route of
// `ops.rwkv6_scan` (bf16 r, k, v with T >= 64, `ops.scan_route`).
//
// Replaces the TPU kernel `rwkv6_scan_pallas`
// (src/repro/kernels/rwkv6_scan.py:73, pl.pallas_call at :99), which is
// chunk-parallel too but forms the in-chunk scores as r W_excl against
// k / max(W_incl, 1e-30): wherever a chunk's decay product falls below
// 1e-30 that clamp makes it wrong (Hymba-1.5B reaches it).  The clamp is not
// carried over.  Computes what `ref_rwkv6` (kernels/ref.py) computes, per
// (b, h):
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t      (the u term only with u)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,          w_t clipped to [1e-8, 1]
// from S_0 = the given state (zeros without one), to fp32 rounding at any
// decay in [1e-8, 1].  r, k: (B, T, H, Dk) bf16, Dk <= 64; v: (B, T, H, Dv)
// bf16, any Dv; w: (B, T, H, Dk) fp32; u: (H, Dk) fp32 or none; state:
// (B, H, Dk, Dv) fp32.  Writes o in bf16 and the final state in fp32;
// state_in may alias state_out.  The step recurrence (rwkv6_scan.cu) is the
// other route: fp32 operands and short T.
//
// Design.  Chunks of C = 64 steps, sub-chunks of 16.  Inside a chunk, L_t
// is the log2-cumsum of the clipped decays before step t (L_0 = 0, fp32,
// segments of 8 steps scanned by shuffles).  No factor is ever divided by
// a running product: every decay factor is exp2 of a difference of L's
// that is <= 0, taken against a reference point, or a product of clipped
// decays, so nothing overflows, and a factor that underflows to 0 is one
// whose true value lies below fp32's range:
//   - the state term: (r_t 2^{L_t}) S_in;
//   - scores of sub-chunk I against an earlier J: (r_t 2^{L_t - L_{16I}})
//     against (k_s 2^{L_{16I} - L_{s+1}});
//   - the diagonal 16 x 16 blocks, on the fp32 cores: sum_d r_t k_s w_{s+1}
//     ... w_{t-1}, the product carried down each column (strictly lower;
//     the u bonus on the diagonal);
//   - a chunk's own state: (k_s 2^{L_C - L_{s+1}})^T v, its decay 2^{L_C}.
// The products run on bf16 tensor cores with fp32 accumulators.  r, k, v
// are bf16 and go in whole; an fp32 operand (a decayed r or k, the scores,
// the carried state) goes in as hi = bf16(x) and lo = bf16(x - hi), and a
// product is hi hi + hi lo + lo hi.  One rounding to bf16 would land
// outputs several bf16 ulps from the recurrence; the split carries ~16
// bits (tests/test_torch_rwkv6_chunk.py emulates both).  The scores' fp32
// accumulator fragment is the A fragment of the product with v, as in
// flash attention; v's B fragments come by ldmatrix.trans.  A chunk's
// operands reach shared memory by 16-byte cp.async copies, all in flight
// at once.  Three launches on the stream, no atomics (a repeated call is
// bitwise equal):
//   1. rwkv6_chunk_state_kernel, one block per (b, h, chunk, 64 columns of
//      Dv): the chunk's own state dS_c (from zero) into `carry`, each
//      warp a quarter of the steps (or of the rows of dS), the partial sums
//      added in shared memory in a fixed order; its decay 2^{L_C} into
//      `decay`;
//   2. rwkv6_chunk_carry_kernel, one thread per (b, h, state entry): walks
//      the chunks in order, S <- decay_c S + dS_c, overwriting carry[c] with
//      the state entering chunk c; writes the final state;
//   3. rwkv6_chunk_out_kernel, one block per (b, h, chunk, 64 columns):
//      four warps, warp I the 16 rows of sub-chunk I: the scores against
//      sub-chunks J < I (mma), the diagonal block (fp32 cores), their
//      product with v (mma), the state term (mma), o stored in bf16.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s; 989 TFLOP/s bf16 tensor
// cores).  The scoring pass's call, (2, 4096, 25) heads with Dk = 16,
// Dv = 64: the function reads r, k, v (bf16), w (fp32) and writes o, 79 MB
// in all (0.024 ms), and its work (~1 GFLOP in the chunk form) is
// negligible on the tensor cores: bound by bytes.  The passes read k, w, v
// twice and move the chunk states (13 MB) three times, about 170 MB
// (0.05 ms at the data sheet's rate).  3,200 chunk blocks per pass keep
// every SM busy, in place of the recurrence's 100 blocks walking 4,096
// dependent steps.  On the card the passes take ~27, ~10 and ~60 us
// (PERF.md): the loads of rows 32-128 bytes long at strides of 0.8-3.2 KB
// reach about half the data sheet's rate, and the out pass's diagonal
// blocks and decay factors are instruction-bound besides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// Kernel operands; mirrored field for field by `Rwkv6ChunkArgs` in
// build.py.  Every tensor contiguous.
struct Rwkv6ChunkArgs {
  const __nv_bfloat16* r;  // (B, T, H, Dk)
  const __nv_bfloat16* k;  // (B, T, H, Dk)
  const __nv_bfloat16* v;  // (B, T, H, Dv)
  const float* w;          // (B, T, H, Dk)
  const float* u;          // (H, Dk) or null: no bonus term
  const float* state_in;   // (B, H, Dk, Dv) or null: zeros
  __nv_bfloat16* out;      // (B, T, H, Dv)
  float* state_out;        // (B, H, Dk, Dv)
  float* carry;            // (B, H, n_chunks, Dk, Dv) scratch
  float* decay;            // (B, H, n_chunks, Dk) scratch
  int batch, steps, num_heads, dk, dv, device;
};

namespace {

constexpr int kChunk = 64;    // steps per chunk
constexpr int kSub = 16;      // steps per sub-chunk (one warp's rows)
constexpr int kCols = 64;     // columns of Dv per block
constexpr int kWarps = kChunk / kSub;
constexpr int kThreads = 32 * kWarps;
constexpr int kVStride = kCols + 8;  // bf16 row of v in shared memory

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// two fp32 values as the bf16 pairs hi = bf16(x), lo = bf16(x - hi)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  return {bits(h), bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y))};
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a in two parts and b whole (bf16 already)
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(d, ahi, b0, b1);
  mma(d, alo, b0, b1);
}

// d += a b with both in two parts: hi hi + hi lo + lo hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], Split b0,
                                     Split b1) {
  mma(d, ahi, b0.hi, b1.hi);
  mma(d, ahi, b0.lo, b1.lo);
  mma(d, alo, b0.hi, b1.hi);
}

// The A fragment (16 x 16, row-major) of an fp32 tile given by `at(row,
// col)`, split in two: lane (g = lane / 4, c = lane % 4) holds rows g and
// g + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9.
template <typename F>
__device__ __forceinline__ void a_frag(F at, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i % 2), col = c + 8 * (i / 2);
    const Split s = split(at(row, col), at(row, col + 1));
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// The A fragment of the 16 x 16 tile held as two m16n8 accumulators (the
// left and right 8 columns), split in two.
__device__ __forceinline__ void acc_to_a(const float (&l)[4],
                                         const float (&r)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const Split s0 = split(l[0], l[1]), s1 = split(l[2], l[3]);
  const Split s2 = split(r[0], r[1]), s3 = split(r[2], r[3]);
  hi[0] = s0.hi, hi[1] = s1.hi, hi[2] = s2.hi, hi[3] = s3.hi;
  lo[0] = s0.lo, lo[1] = s1.lo, lo[2] = s2.lo, lo[3] = s3.lo;
}

// Shared memory of a chunk block: fp32 rows of DK + 4, bf16 rows of DK + 8
// (16-byte aligned, for cp.async).  The state pass uses the fields before
// `r` only, and allocates only those.
template <int DK>
struct Smem {
  static constexpr int DP = DK + 4, KP = DK + 8;
  float L[kChunk + 1][DP];  // L[t][d] = sum_{s < t} log2 w_s[d] in the chunk
  float W[kChunk][DP];      // w clipped to [1e-8, 1] (1 past T and Dk)
  __nv_bfloat16 k[kChunk][KP];
  __nv_bfloat16 v[kChunk][kVStride];
  __nv_bfloat16 r[kChunk][KP];
  float S[DK][kCols + 4];   // the state entering the chunk (output pass)
  float u[DK];
  float diag[kWarps][kSub][kSub + 1];  // each warp's diagonal score block
};
template <int DK>
constexpr size_t kStateSmem = offsetof(Smem<DK>, r);
// the state pass's partial sums reuse its staged operands' space
static_assert(sizeof(float) * kWarps * 16 * (kCols + 4) <= kStateSmem<16>,
              "partial sums do not fit");

// 16 bytes global -> shared, in flight until cp_wait; zeros when !in
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage the chunk's operands (r only with `with_r`, S_in and u only with
// `with_s`) and the log2-cumsums of its decays.  Steps past T read as
// r = k = v = 0, w = 1; channels past Dk as r = k = 0, w = 1.  With VEC
// (Dk and Dv multiples of 8, operands on 16-byte boundaries) every row
// moves in 16-byte cp.async copies, all in flight at once; else element
// by element.  w lands raw in L[t + 1] and the cumsum takes its log2.
template <int DK, bool VEC>
__device__ void stage(const Rwkv6ChunkArgs& a, Smem<DK>& sm, int b, int h,
                      int c, int j0, bool with_r, bool with_s) {
  const int T = a.steps, H = a.num_heads, Dk = a.dk, Dv = a.dv;
  const int t0 = c * kChunk, n = (T + kChunk - 1) / kChunk;
  const float* s_in = a.carry + (((size_t)b * H + h) * n + c) * Dk * Dv;
  if (VEC) {
    for (int i = threadIdx.x; i < kChunk * DK / 8; i += kThreads) {
      const int t = i / (DK / 8), d = 8 * (i % (DK / 8));
      const bool in = t0 + t < T && d < Dk;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dk + d;
      cp16(&sm.k[t][d], in ? a.k + src : a.k, in);
      if (with_r) cp16(&sm.r[t][d], in ? a.r + src : a.r, in);
      cp16(&sm.L[t + 1][d], in ? a.w + src : a.w, in);
      cp16(&sm.L[t + 1][d + 4], in ? a.w + src + 4 : a.w, in);
    }
    for (int i = threadIdx.x; i < kChunk * kCols / 8; i += kThreads) {
      const int t = i / (kCols / 8), j = 8 * (i % (kCols / 8));
      const bool in = t0 + t < T && j0 + j < Dv;
      const __nv_bfloat16* src =
          a.v + (((size_t)b * T + t0 + t) * H + h) * Dv + j0 + j;
      cp16(&sm.v[t][j], in ? src : a.v, in);
    }
    if (with_s)
      for (int i = threadIdx.x; i < DK * kCols / 4; i += kThreads) {
        const int d = i / (kCols / 4), j = 4 * (i % (kCols / 4));
        const bool in = d < Dk && j0 + j < Dv;
        cp16(&sm.S[d][j], in ? s_in + (size_t)d * Dv + j0 + j : a.carry,
             in);
      }
  } else {
    for (int i = threadIdx.x; i < kChunk * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      const bool in = t0 + t < T && d < Dk;
      const size_t src = (((size_t)b * T + t0 + t) * H + h) * Dk + d;
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      sm.L[t + 1][d] = in ? a.w[src] : 1.f;
      sm.k[t][d] = in ? a.k[src] : zero;
      if (with_r) sm.r[t][d] = in ? a.r[src] : zero;
    }
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int t = i / kCols, j = i % kCols;
      const bool in = t0 + t < T && j0 + j < Dv;
      sm.v[t][j] = in ? a.v[(((size_t)b * T + t0 + t) * H + h) * Dv + j0 + j]
                      : __float2bfloat16(0.f);
    }
    if (with_s)
      for (int i = threadIdx.x; i < DK * kCols; i += kThreads) {
        const int d = i / kCols, j = i % kCols;
        sm.S[d][j] = (d < Dk && j0 + j < Dv) ? s_in[(size_t)d * Dv + j0 + j]
                                             : 0.f;
      }
  }
  if (with_s)
    for (int d = threadIdx.x; d < DK; d += kThreads)
      sm.u[d] = (a.u && d < Dk) ? a.u[h * Dk + d] : 0.f;
  if (threadIdx.x < DK) sm.L[0][threadIdx.x] = 0.f;
  if (VEC) cp_wait();
  __syncthreads();
  // the cumsum, in segments of 8 steps: lane (i = lane % 8, dq = lane / 8)
  // of warp w takes step 8 sg + i of channel 4 q + dq, for the channel
  // groups q = w, w + 4, ... (conflict-free: the rows' strides are 4 mod
  // 32 banks); each segment is scanned in 3 shuffles, all of them
  // independently, then offset by the totals of the segments before it
  const int lane = threadIdx.x % 32, i = lane % 8, dq = lane / 8;
  for (int q = threadIdx.x / 32; q < DK / 4; q += kWarps) {
    const int d = 4 * q + dq;
    float x[kChunk / 8];
#pragma unroll
    for (int sg = 0; sg < kChunk / 8; ++sg) {
      const int t = 8 * sg + i;
      const bool in = t0 + t < T && d < Dk;
      const float w = in ? fminf(fmaxf(sm.L[t + 1][d], 1e-8f), 1.0f) : 1.f;
      sm.W[t][d] = w;
      float y = log2f(w);
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        const float z = __shfl_up_sync(0xffffffffu, y, off, 8);
        if (i >= off) y += z;
      }
      x[sg] = y;
    }
    float before = 0.f;
#pragma unroll
    for (int sg = 0; sg < kChunk / 8; ++sg) {
      const float total = __shfl_sync(0xffffffffu, x[sg], 7, 8);
      sm.L[8 * sg + i + 1][d] = x[sg] + before;
      before += total;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The B fragments of v rows [s0, s0 + 16), columns [8 nt, 8 nt + 16) (two
// n-tiles; lane holds rows 2c, 2c + 1 and 2c + 8, 2c + 9 of column g of
// each), by one ldmatrix.x4.trans from the row-major tile.
__device__ __forceinline__ void v_frags(const __nv_bfloat16 (*v)[kVStride],
                                        int s0, int nt, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const __nv_bfloat16* p = &v[s0 + 8 * (m % 2) + lane % 8][8 * (nt + m / 2)];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Eight bf16 (16 bytes of shared memory) as floats.
__device__ __forceinline__ void unpack8(const __nv_bfloat16* p,
                                        float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The warp's diagonal score block, rows t and columns s in [t0, t0 + 16):
// sum_d r_t k_s w_{s+1} ... w_{t-1} for s < t (the decays carried down
// each column as a running product k_s w_{s+1} ... of the clipped decays:
// no exp, no division), the u bonus at s = t, 0 above.  Lane (s = t0 +
// lane % 16, half = lane / 16) walks column s over its half of the
// channels, eight at a time (16-byte loads of r and w, broadcast across
// the column's lanes); the two halves meet in a shuffle.  Written to
// sm.diag[warp].
template <int DK>
__device__ void diag_block(Smem<DK>& sm, int t0, bool bonus) {
  constexpr int kHalf = DK / 2, kGroup = 8;
  const int lane = threadIdx.x % 32, sl = lane % 16;
  const int s = t0 + sl, d0 = (lane / 16) * kHalf;
  float xs[kSub] = {}, xb = 0.f;
  for (int dg = 0; dg < kHalf; dg += kGroup) {
    const int d = d0 + dg;
    float kk[kGroup], kp[kGroup], x8[kGroup];
    unpack8(&sm.k[s][d], kk);
    if (bonus) {
      unpack8(&sm.r[s][d], x8);
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        xb = fmaf(x8[i] * sm.u[d + i], kk[i], xb);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) kp[i] = 0.f;
#pragma unroll
    for (int tl = 1; tl < kSub; ++tl) {
      // kp: 0 down to row s, then k_s, then times w_{t-1} a row
      const float4 w0 = *reinterpret_cast<const float4*>(&sm.W[t0 + tl - 1][d]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&sm.W[t0 + tl - 1][d + 4]);
      const float w[kGroup] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
      unpack8(&sm.r[t0 + tl][d], x8);
      const bool first = tl == sl + 1;
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        kp[i] = first ? kk[i] : kp[i] * w[i];
        x = fmaf(x8[i], kp[i], x);
      }
      xs[tl] += x;
    }
  }
  float (*out)[kSub + 1] = sm.diag[threadIdx.x / 32];
#pragma unroll
  for (int tl = 0; tl < kSub; ++tl) {
    const float x = xs[tl] + __shfl_xor_sync(0xffffffffu, xs[tl], 16);
    if (lane < 16) out[tl][sl] = x;  // 0 for tl <= sl
  }
  xb += __shfl_xor_sync(0xffffffffu, xb, 16);
  if (lane < 16 && bonus) out[sl][sl] = xb;
  __syncwarp();
}

// ADJ: the backward's pass over a chunk's own adjoint
// (rwkv6_chunk_bwd.cu, `repro_rwkv6_chunk_adjoint`), called with k = r and
// v = dO: sum_s (r_s 2^{L_s})^T dO_s, the adjoint entering the chunk from
// zero at its end (every exponent L_s <= 0); the decay is the same.
template <int DK, bool VEC, bool ADJ>
__global__ void __launch_bounds__(kThreads) rwkv6_chunk_state_kernel(
    const Rwkv6ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DK>& sm = *reinterpret_cast<Smem<DK>*>(smem_raw);
  const int H = a.num_heads, Dk = a.dk, Dv = a.dv;
  const int n = (a.steps + kChunk - 1) / kChunk;
  const int bh = blockIdx.x / n, c = blockIdx.x % n;
  const int b = bh / H, h = bh % H, j0 = blockIdx.y * kCols;
  stage<DK, VEC>(a, sm, b, h, c, j0, false, false);

  // dS = (k 2^{L_C - L_{s+1}})^T v: rows d, columns j, summed over the
  // chunk's steps s.  Warp w takes m-tile w % kMT (16 rows d) over K-slice
  // w / kMT of the steps, all 8 n-tiles, so each decayed k is formed once;
  // the slices' partial sums meet in shared memory and are added in order
  constexpr int kMT = DK / 16, kSplit = kWarps / kMT;
  constexpr int kSteps = kChunk / kSplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp % kMT, slice = warp / kMT;
  float acc[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < kSteps / 16; ++ks) {
    const int s0 = slice * kSteps + 16 * ks;
    uint32_t hi[4], lo[4];
    a_frag(
        [&](int row, int col) {
          const int d = 16 * mt + row, s = s0 + col;
          return f32(sm.k[s][d]) *
                 exp2f(ADJ ? sm.L[s][d] : sm.L[kChunk][d] - sm.L[s + 1][d]);
        },
        hi, lo);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bv[4];
      v_frags(sm.v, s0, nt, bv);
      mma2(acc[nt], hi, lo, bv[0], bv[1]);
      mma2(acc[nt + 1], hi, lo, bv[2], bv[3]);
    }
  }
  const float last = threadIdx.x < DK ? sm.L[kChunk][threadIdx.x] : 0.f;
  __syncthreads();  // the staged operands are read: reuse their space
  float (*part)[16][kCols + 4] =
      reinterpret_cast<float (*)[16][kCols + 4]>(smem_raw);
  const int g = lane / 4, cc = 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[warp][g + 8 * (e / 2)][8 * nt + cc + e % 2] = acc[nt][e];
  __syncthreads();
  const size_t base = (((size_t)b * H + h) * n + c) * Dk;
  for (int i = threadIdx.x; i < DK * kCols / 4; i += kThreads) {
    const int d = i / (kCols / 4), j = 4 * (i % (kCols / 4));
    if (d >= Dk || j0 + j >= Dv) continue;
    float4 sum = *reinterpret_cast<const float4*>(&part[d / 16][d % 16][j]);
#pragma unroll
    for (int sl = 1; sl < kSplit; ++sl) {
      const float4 x =
          *reinterpret_cast<const float4*>(&part[d / 16 + sl * kMT][d % 16][j]);
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    float* dst = a.carry + (base + d) * Dv + j0 + j;
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = sum;
    } else {
      const float x[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int e = 0; e < 4 && j0 + j + e < Dv; ++e) dst[e] = x[e];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < Dk)
    a.decay[base + threadIdx.x] = exp2f(last);
}

__global__ void __launch_bounds__(kThreads) rwkv6_chunk_carry_kernel(
    const Rwkv6ChunkArgs a) {
  const int Dk = a.dk, Dv = a.dv;
  const int n = (a.steps + kChunk - 1) / kChunk;
  const size_t entries = (size_t)Dk * Dv;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)a.batch * a.num_heads * entries) return;
  const size_t bh = idx / entries, e = idx % entries;
  const int d = (int)(e / Dv);
  float S = a.state_in ? a.state_in[idx] : 0.f;
  float* carry = a.carry + bh * n * entries + e;
  const float* decay = a.decay + bh * n * Dk + d;
  constexpr int kBatch = 32;  // loads of a batch issued before its stores
  for (int c0 = 0; c0 < n; c0 += kBatch) {
    float ds[kBatch], dc[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool in = c0 + i < n;
      ds[i] = in ? carry[(size_t)(c0 + i) * entries] : 0.f;
      dc[i] = in ? decay[(size_t)(c0 + i) * Dk] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < n) {
        carry[(size_t)(c0 + i) * entries] = S;
        S = fmaf(dc[i], S, ds[i]);
      }
    }
  }
  a.state_out[idx] = S;
}

template <int DK, bool VEC>
__global__ void __launch_bounds__(kThreads) rwkv6_chunk_out_kernel(
    const Rwkv6ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DK>& sm = *reinterpret_cast<Smem<DK>*>(smem_raw);
  const int T = a.steps, H = a.num_heads, Dv = a.dv;
  const int n = (T + kChunk - 1) / kChunk;
  const int bh = blockIdx.x / n, c = blockIdx.x % n;
  const int b = bh / H, h = bh % H, j0 = blockIdx.y * kCols;
  stage<DK, VEC>(a, sm, b, h, c, j0, true, true);

  constexpr int kKS = DK / 16;
  const int I = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cc = 2 * (lane % 4);
  const int t0 = kSub * I;  // the warp's rows, in the chunk
  float acc[8][4] = {};

  // r 2^{L_t - L_{t0}} of the warp's rows: the A operand of every score
  // block against an earlier sub-chunk
  uint32_t qhi[kKS][4], qlo[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    a_frag(
        [&](int row, int col) {
          const int t = t0 + row, d = 16 * ks + col;
          return f32(sm.r[t][d]) * exp2f(sm.L[t][d] - sm.L[t0][d]);
        },
        qhi[ks], qlo[ks]);

  for (int J = 0; J <= I; ++J) {
    const int s0 = kSub * J;
    float sc[2][4] = {};  // scores of rows t0.. against columns s0..
    if (J < I) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // B operand: k_s 2^{L_{t0} - L_{s+1}}, rows d, column s
          const int s = s0 + 8 * nt + g;
          const int d = 16 * ks + cc;
          const __nv_bfloat16* kr = sm.k[s];
          const float* ls = sm.L[s + 1];
          const float* lt = sm.L[t0];
          const Split b0 = split(f32(kr[d]) * exp2f(lt[d] - ls[d]),
                                 f32(kr[d + 1]) * exp2f(lt[d + 1] - ls[d + 1]));
          const Split b1 =
              split(f32(kr[d + 8]) * exp2f(lt[d + 8] - ls[d + 8]),
                    f32(kr[d + 9]) * exp2f(lt[d + 9] - ls[d + 9]));
          mma3(sc[nt], qhi[ks], qlo[ks], b0, b1);
        }
    } else {
      diag_block<DK>(sm, t0, a.u != nullptr);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sc[e / 4][e % 4] =
            sm.diag[I][g + 8 * ((e / 2) % 2)][8 * (e / 4) + cc + e % 2];
    }
    uint32_t ahi[4], alo[4];
    acc_to_a(sc[0], sc[1], ahi, alo);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bv[4];
      v_frags(sm.v, s0, nt, bv);
      mma2(acc[nt], ahi, alo, bv[0], bv[1]);
      mma2(acc[nt + 1], ahi, alo, bv[2], bv[3]);
    }
  }

  // the state term: (r 2^{L_t}) S_in
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    uint32_t hi[4], lo[4];
    a_frag(
        [&](int row, int col) {
          const int t = t0 + row, d = 16 * ks + col;
          return f32(sm.r[t][d]) * exp2f(sm.L[t][d]);
        },
        hi, lo);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = 16 * ks + cc, j = 8 * nt + g;
      mma3(acc[nt], hi, lo, split(sm.S[d][j], sm.S[d + 1][j]),
           split(sm.S[d + 8][j], sm.S[d + 9][j]));
    }
  }

  // o in bf16: rows t0 + g and t0 + g + 8, columns 8 nt + cc, + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = c * kChunk + t0 + g + 8 * half;
    if (t >= T) continue;
    __nv_bfloat16* row = a.out + (((size_t)b * T + t) * H + h) * Dv;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = j0 + 8 * nt + cc;
      const float x0 = acc[nt][2 * half], x1 = acc[nt][2 * half + 1];
      if (j + 1 < Dv && Dv % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + j) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (j < Dv) row[j] = __float2bfloat16(x0);
        if (j + 1 < Dv) row[j + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// The three kernels of a chunked scan; with `adjoint`, the state pass
// alone in its ADJ form.
template <int DK, bool VEC>
int launch(const Rwkv6ChunkArgs& a, cudaStream_t s, bool adjoint) {
  const int n = (a.steps + kChunk - 1) / kChunk;
  const size_t smem = sizeof(Smem<DK>), state_smem = kStateSmem<DK>;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_chunk_state_kernel<DK, VEC, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_chunk_state_kernel<DK, VEC, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)state_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_chunk_out_kernel<DK, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    attrs = true;
  }
  const dim3 grid((unsigned)(a.batch * a.num_heads * n),
                  (a.dv + kCols - 1) / kCols);
  if (adjoint) {
    if (n > 0)
      rwkv6_chunk_state_kernel<DK, VEC, true>
          <<<grid, kThreads, state_smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (n > 0) {
    rwkv6_chunk_state_kernel<DK, VEC, false>
        <<<grid, kThreads, state_smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t entries = (size_t)a.batch * a.num_heads * a.dk * a.dv;
  rwkv6_chunk_carry_kernel<<<(unsigned)((entries + kThreads - 1) / kThreads),
                             kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  rwkv6_chunk_out_kernel<DK, VEC><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DK>
int dispatch(const Rwkv6ChunkArgs& a, cudaStream_t s, bool adjoint) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.dk % 8 == 0 && a.dv % 8 == 0 && aligned(a.r) &&
                   aligned(a.k) && aligned(a.v) && aligned(a.w) &&
                   aligned(a.carry);
  return vec ? launch<DK, true>(a, s, adjoint)
             : launch<DK, false>(a, s, adjoint);
}

int checked_dispatch(const Rwkv6ChunkArgs& a, void* stream, bool adjoint) {
  if (a.batch < 0 || a.steps < 0 || a.num_heads < 1 || a.dk < 1 ||
      a.dk > 64 || a.dv < 1 || (a.dv + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dk <= 16) return dispatch<16>(a, s, adjoint);
  if (a.dk <= 32) return dispatch<32>(a, s, adjoint);
  return dispatch<64>(a, s, adjoint);
}

}  // namespace

extern "C" {

// Launches the three kernels of one chunked scan on `stream`; returns a
// cudaError_t (0 = success).  Dk above 64 and negative sizes are refused
// (cudaErrorInvalidValue).
int repro_rwkv6_chunk(const Rwkv6ChunkArgs* args, void* stream) {
  return checked_dispatch(*args, stream, false);
}

// The first pass of the chunk-parallel backward (rwkv6_chunk_bwd.cu): the
// state kernel in its ADJ form, with k = r and v = dO, writing each
// chunk's own adjoint (from zero at its end) into `carry` and its decay
// into `decay`; r, out, state_in, state_out and u are not read.  Returns a
// cudaError_t, refusing what `repro_rwkv6_chunk` refuses.
int repro_rwkv6_chunk_adjoint(const Rwkv6ChunkArgs* args, void* stream) {
  return checked_dispatch(*args, stream, true);
}

}  // extern "C"
