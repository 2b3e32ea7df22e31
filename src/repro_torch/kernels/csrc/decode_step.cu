// Fused decode step of the latent-query policy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_step_pallas`
// (src/repro/kernels/decode_attention.py:239, pl.pallas_call at :274).
// Computes exactly what `ref_decode_step` (kernels/ref.py) computes, in
// fp32, for each lane b of the batch:
//   1. append: K/V projections of the new token x_new[b] for every layer
//      land in the caller's cache at slot[b] (skipped outside [0, C));
//   2. decode: the latent query q0 runs through L pre-LN layers (LN -> q ->
//      per-head attention over slots 0..lengths[b] -> proj -> LN ->
//      tanh-GELU MLP), then the final LN gives y;
//   3. sample: readout logits * logit_temp, masked to -FLT_MAX,
//      log-softmax, Gumbel-max action (ties to the lowest index), log_pf.
//
// What bounds it.  At the serving shape (L=3, D=64, H=8, C=16, F=256,
// A=3840, 64 lanes) a step reads 1.57 MB of weights and ~2 MB of cache,
// noise and masks and does 50.7 MFLOP: 1.1 us at 3.35 TB/s (H100 SXM data
// sheet).  It is nowhere near that: a lane's step is a chain of ~40
// dependent phases (per layer 2 layernorms, 4 GEMVs, attention and 4
// exchanges; then the readout and two merges), and on this card each link
// of it costs hundreds of cycles (`scripts/decode_step_trace.py`).
//
// Design.  A thread-block cluster of kRanks = 8 blocks takes a tile of
// kTile = 8 lanes (grid = ceil(B / 8) clusters).  Every rank keeps the
// tile's whole running state in its shared memory, laid out (K, kTile) so
// one 32-byte read serves a row to all 8 lanes, and owns a share of each
// GEMV's output columns: heads [h0, h1) for the append, q and attention
// (it keeps the K/V rows it appends in shared memory and attends them from
// there), and 1/8 of proj, ff1, ff2 and the readout's A columns.
//  * GEMV: a warp takes column pairs and splits K into row slices; a
//    thread loads a row's 8 bytes and feeds them to all 8 lanes (16 fp32
//    accumulators), so each weight byte a cluster reads serves the whole
//    tile; it loads the next batch of rows while it sums the current one,
//    and a GEMV's first batch is loaded before the wait for its input.  The
//    row slices are summed by an xor-shuffle reduce-scatter.
//  * Exchanges: the owner of a column writes its outputs into every rank's
//    copy with st.async, counted on the receiver's mbarrier, and the
//    receivers wait on that.  A cluster barrier would do the same in ~830
//    cycles and more: its release / acquire waits for all the SM's memory
//    operations (the weight loads in flight too) and invalidates its L1.
//  * Parameters (LN scales, biases, this rank's b_out share) arrive by
//    cp.async, all at once, before the chain starts.
//  * Layernorm: one warp per lane, warp shuffles, computed by every rank.
//  * Readout: each rank forms its A slice's masked logits and their
//    (max, sum exp); the ranks' partials merge in rank order into lse; each
//    rank then takes its slice's argmax of (ml - lse) + g and rank 0 merges
//    the 8 candidates in rank order (ties to the lowest index).
//  * Three blocks a SM (80 registers a thread): the card then holds 45
//    clusters at once, so 256 lanes (32 clusters) run in one wave; at two
//    blocks a SM it holds fewer than 32 and 256 lanes take two.
// Every lane's sums run in an order fixed by the shape alone, so a lane's
// outputs are bitwise independent of its tile, its place in it and its
// neighbours; there are no atomics, so a repeated call is bitwise equal.
// tests/test_torch_decode_step_split.py repeats this arithmetic on the CPU.
//
// Append in place.  The Pallas kernel copies the whole cache to a new
// output; this kernel writes only the new token's rows into the caller's
// cache.  Cache reads stay plain loads (not __ldg).
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py): 52.3 us
// at 1 lane, 56.6 us at 64, 73.1 us at 256 (the previous design, one
// block a lane: 85.2 / 94.1 / 94.3 us in the same run).
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

// Kernel operands; mirrored field for field by `DecodeStepArgs` in build.py.
struct DecodeStepArgs {
  // activations and lane state
  const float* x_new;       // (B, D)
  float* k_cache;           // (L, B, C, D), appended in place
  float* v_cache;           // (L, B, C, D), appended in place
  const int* lengths;       // (B,) live tokens; slots 0..lengths[b] attended
  const int* slot;          // (B,) append slot
  const float* logit_temp;  // (B,) or null (= 1)
  const float* gumbel;      // (B, A)
  const uint8_t* mask;      // (B, A) bool, nonzero = legal
  // stacked decoder weights
  const float* ln1_scale;   // (L, D)
  const float* ln1_bias;    // (L, D)
  const float* q_w;         // (L, D, D)
  const float* q_b;         // (L, D)
  const float* kv_w;        // (L, D, 2D)
  const float* kv_b;        // (L, 2D)
  const float* proj_w;      // (L, D, D)
  const float* proj_b;      // (L, D)
  const float* ln2_scale;   // (L, D)
  const float* ln2_bias;    // (L, D)
  const float* ff1_w;       // (L, D, F)
  const float* ff1_b;       // (L, F)
  const float* ff2_w;       // (L, F, D)
  const float* ff2_b;       // (L, D)
  const float* lnf_scale;   // (D,)
  const float* lnf_bias;    // (D,)
  const float* q0;          // (D,)
  const float* w_out;       // (D, A)
  const float* b_out;       // (A,)
  // outputs
  int* action;              // (B,)
  float* log_pf;            // (B,)
  float* y;                 // (B, D)
  // shapes
  int num_layers, batch, capacity, dim, num_heads, ff_dim, num_actions;
  int device;
};

namespace {

constexpr int kRanks = 8;    // blocks of a cluster
constexpr int kTile = 8;     // lanes of a cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == kTile, "layernorm and the readout take a warp a lane");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 2;    // weight rows a thread loads in one step

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (value, index) argmax; ties resolve to the lowest index, as jnp.argmax.
__device__ __forceinline__ void arg_better(float& v, int& i, float& x,
                                           float v2, int i2, float x2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    x = x2;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Exchanges between the ranks go through mbarriers, not cluster barriers
// (a cluster barrier's release / acquire waits for every outstanding
// memory operation of the SM and invalidates its L1): a sender writes
// into another rank's shared memory with st.async, which counts the bytes
// on the receiver's mbarrier, and the receiver waits for the barrier's
// phase to complete.  Every gather takes data from all ranks, so no rank
// can send phase k + 1 of a barrier before the receiver has finished
// waiting for phase k, and each buffer is read before anyone can write it
// again.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Arms the barrier's current phase for `bytes` bytes (this thread is its
// one arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Store v at the address of p in rank q's shared memory, counted on rank
// q's copy of `bar`.
__device__ __forceinline__ void store_rank(float* p, int q, uint64_t* bar,
                                           float v) {
  uint32_t dst, rbar;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(dst) : "r"(smem_addr(p)), "r"(q));
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(rbar) : "r"(smem_addr(bar)), "r"(q));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(rbar)
      : "memory");
}

// Store v at the address of p in the shared memory of every rank.
__device__ __forceinline__ void push(float* p, uint64_t* bar, float v) {
#pragma unroll
  for (int q = 0; q < kRanks; ++q) store_rank(p, q, bar, v);
}

// An asynchronous 4-byte copy global -> shared (cp.async; completes at
// cp_async_wait).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A rank's share [j0, j1) of n columns: chunks of a multiple of 4, so each
// rank's 16-byte column groups start on a 16-byte boundary.
struct Cols {
  int j0, j1;
};
__device__ __forceinline__ Cols split_cols(int n, int r) {
  const int chunk = ((n + kRanks - 1) / kRanks + 3) & ~3;
  const int j0 = min(r * chunk, n);
  return {j0, min(j0 + chunk, n)};
}

// One GEMV of the chain: `parts` weight blocks, block p at
// w + (p / split) * s1 + (p % split) * s2, each a row-major (K, ld) matrix
// of which this rank takes columns [j0, j1).
struct Gemv {
  const float* w;
  size_t s1, s2;
  int split, parts, ld, j0, j1, K;
};

// Row i of a pair of columns (n of them real) at w: one 8-byte load when
// `vec`.
__device__ __forceinline__ float2 load_pair(const float* w, int ld, int i,
                                            int n, bool vec) {
  const float* p = w + (size_t)i * ld;
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), n > 1 ? __ldg(p + 1) : 0.f);
}

// One xor-shuffle step of the reduce-scatter: of its N accumulators a
// thread keeps the half its partner at offset o does not, plus the
// partner's copy of that half.
template <int N>
__device__ __forceinline__ void scatter_step(float* acc, int t, int o) {
  const bool up = t & o;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? acc[i] : acc[i + N / 2];
    const float keep = up ? acc[i + N / 2] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

// A thread's walk through gemv<CPW>: passes over pairs of columns, nb
// batches of kBatch rows per pass.  A warp takes CPW pairs at a time and
// 32 / CPW row slices; this thread's rows are slice, slice + 32 / CPW, ...
template <int CPW>
struct Walk {
  static_assert(CPW >= 2 && CPW <= 16, "2 to 16 column pairs a warp");
  static constexpr int kSlices = 32 / CPW;
  int ncol, g1, nb, passes;
  __device__ __forceinline__ explicit Walk(const Gemv& gm) {
    const int warp = threadIdx.x >> 5;
    ncol = gm.j1 - gm.j0;
    g1 = (ncol + 1) / 2;
    nb = (gm.K + kBatch * kSlices - 1) / (kBatch * kSlices);
    const int all = (gm.parts * g1 + CPW - 1) / CPW;  // passes of the block
    passes = all > warp ? (all - warp + kWarps - 1) / kWarps : 0;
  }
};

// This thread's pair of columns in its k-th pass of a walk.
struct Pair {
  const float* w;  // row 0 of the first column
  int n;           // columns that exist (0 past the last pair)
  int col;         // output column of the first, p * (j1 - j0) + jj
  bool vec;        // one 8-byte load a row
};
template <int CPW>
__device__ __forceinline__ Pair pair_of(const Gemv& gm, const Walk<CPW>& wk,
                                        int k) {
  const int gi = ((threadIdx.x >> 5) + k * kWarps) * CPW + threadIdx.x % CPW;
  const int part = gi / wk.g1, jj = 2 * (gi % wk.g1);
  Pair p;
  p.w = gm.w + (part / gm.split) * gm.s1 + (part % gm.split) * gm.s2 + gm.j0 +
        jj;
  p.n = k < wk.passes && part < gm.parts ? min(2, wk.ncol - jj) : 0;
  p.col = part * wk.ncol + jj;
  p.vec = p.n == 2 &&
          ((reinterpret_cast<uintptr_t>(p.w) | gm.ld * 4) & 7) == 0;
  return p;
}

// Rows i0, i0 + 32 / CPW, ... (kBatch of them) of a pair: zeros past K or
// past the last pair.
template <int CPW>
__device__ __forceinline__ void load_rows(const Pair& p, int ld, int K,
                                          int i0, float2* wv) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = i0 + u * Walk<CPW>::kSlices;
    wv[u] = p.n && i < K ? load_pair(p.w, ld, i, p.n, p.vec)
                         : make_float2(0.f, 0.f);
  }
}

// out[col * ostride + lane] = sum_i in[i][lane] * W_p[i, j0 + jj] for every
// column col = p * (j1 - j0) + jj of the GEMV; `in` is (K, kTile) in shared
// memory, `wv` the thread's first batch, loaded by gemv_first ahead of the
// wait for `in`, so the L2 round trip overlaps it.  A thread keeps
// 2 x kTile accumulators (index c * kTile + lane) over its rows in order
// and loads each batch while it sums the one before; at a pass's end the
// row slices are summed by log2(32 / CPW) shuffle steps, which leave
// CPW / 2 sums in each thread.
template <int CPW>
__device__ __forceinline__ void gemv(const float* in, const Gemv& gm,
                                     float2* wv, float* out, int ostride) {
  constexpr int kSlices = Walk<CPW>::kSlices;
  constexpr int kSums = CPW / 2;  // a thread's sums after the shuffles
  const Walk<CPW> walk(gm);
  const int t = threadIdx.x & 31, s = t / CPW;
  Pair cur = pair_of<CPW>(gm, walk, 0);
#pragma unroll 1
  for (int k = 0; k < walk.passes; ++k) {
    const Pair nxt = pair_of<CPW>(gm, walk, k + 1);
    float acc[2 * kTile];
#pragma unroll
    for (int a = 0; a < 2 * kTile; ++a) acc[a] = 0.f;
#pragma unroll 1
    for (int b = 0; b < walk.nb; ++b) {
      float2 next[kBatch];  // loaded while this batch is summed
      if (b + 1 < walk.nb)
        load_rows<CPW>(cur, gm.ld, gm.K, s + (b + 1) * kBatch * kSlices,
                       next);
      else
        load_rows<CPW>(nxt, gm.ld, gm.K, s, next);
      const int i0 = s + b * kBatch * kSlices;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= gm.K) break;
        const float4 x0 = *reinterpret_cast<const float4*>(in + i * kTile);
        const float4 x1 =
            *reinterpret_cast<const float4*>(in + i * kTile + 4);
        const float x[kTile] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int l = 0; l < kTile; ++l) {
          acc[l] = fmaf(wv[u].x, x[l], acc[l]);
          acc[kTile + l] = fmaf(wv[u].y, x[l], acc[kTile + l]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) wv[u] = next[u];
    }
    if constexpr (CPW <= 16) scatter_step<16>(acc, t, 16);
    if constexpr (CPW <= 8) scatter_step<8>(acc, t, 8);
    if constexpr (CPW <= 4) scatter_step<4>(acc, t, 4);
    if constexpr (CPW <= 2) scatter_step<2>(acc, t, 2);
#pragma unroll
    for (int v = 0; v < kSums; ++v) {
      const int a = t / CPW * kSums + v;
      const int c = a / kTile, l = a % kTile;
      if (c < cur.n) out[(cur.col + c) * ostride + l] = acc[v];
    }
    cur = nxt;
  }
}

// The first batch of a thread's walk through gemv<CPW>, loaded early.
template <int CPW>
__device__ __forceinline__ void gemv_first(const Gemv& gm, float2* wv) {
  const Walk<CPW> walk(gm);
  load_rows<CPW>(pair_of<CPW>(gm, walk, 0), gm.ld, gm.K,
                 (threadIdx.x & 31) / CPW, wv);
}

// A GEMV over columns [j0, j1) of layer l's (K, N) weight in a stack.
__device__ __forceinline__ Gemv layer_gemv(const float* stack, int l, int K,
                                           int N, int j0, int j1) {
  return {stack + (size_t)l * K * N, 0, 0, 1, 1, N, j0, j1, K};
}

// out = LN(in) * scale + bias per lane, population variance; warp w takes
// lane w (every rank computes it for the whole tile).  scale and bias lie
// in shared memory.
__device__ __forceinline__ void layernorm(const float* in, float* out,
                                       const float* scale, const float* bias,
                                       int n) {
  const int t = threadIdx.x & 31, l = threadIdx.x >> 5;
  float s = 0.f;
  for (int i = t; i < n; i += 32) s += in[i * kTile + l];
  const float mu = warp_sum(s) / n;
  float s2 = 0.f;
  for (int i = t; i < n; i += 32) {
    const float d = in[i * kTile + l] - mu;
    s2 += d * d;
  }
  const float var = warp_sum(s2) / n;
  const float r = 1.f / sqrtf(var + 1e-5f);
  for (int i = t; i < n; i += 32)
    out[i * kTile + l] = (in[i * kTile + l] - mu) * r * scale[i] + bias[i];
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Sections of the parameter block, in order: ln1 / ln2 scale and bias
// (L, D) each, the final LN's (D) each, q_b (L, D), kv_b (L, 2D),
// proj_b (L, D), ff1_b (L, F), ff2_b (L, D), this rank's b_out share.
enum Par { kLn1s, kLn1b, kLn2s, kLn2b, kLnfs, kLnfb, kQb, kKvb, kPb, kF1b,
           kF2b, kBo };
__device__ __forceinline__ int par_offset(Par sec, int L, int D, int F) {
  switch (sec) {
    case kLn1s: return 0;
    case kLn1b: return L * D;
    case kLn2s: return 2 * L * D;
    case kLn2b: return 3 * L * D;
    case kLnfs: return 4 * L * D;
    case kLnfb: return 4 * L * D + D;
    case kQb: return 4 * L * D + 2 * D;
    case kKvb: return 5 * L * D + 2 * D;
    case kPb: return 7 * L * D + 2 * D;
    case kF1b: return 8 * L * D + 2 * D;
    case kF2b: return 8 * L * D + 2 * D + L * F;
    default: return 9 * L * D + 2 * D + L * F;  // kBo
  }
}

// Shared memory of one rank, in floats; every section starts on 16 bytes.
struct Smem {
  int xs, h, g, o, ff, q, nkv, p, res, lg_ld, par, total;
};
__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline Smem smem_layout(int L, int D, int F, int H,
                                            int C, int A) {
  const int qw = (H + kRanks - 1) / kRanks * (D / H);  // most q columns
  const int dw = ((D + kRanks - 1) / kRanks + 3) & ~3;  // of a rank
  const int fw = ((F + kRanks - 1) / kRanks + 3) & ~3;
  Smem s;
  s.lg_ld = ((A + kRanks - 1) / kRanks + 3) & ~3;  // a rank's A share
  const int res = max(max(2 * L * qw, max(dw, fw)) * kTile,
                      s.lg_ld * (kTile + 1));
  s.xs = 0;                                    // (D, kTile) new token
  s.h = align4(s.xs + D * kTile);              // (D, kTile) running state
  s.g = align4(s.h + D * kTile);               // (D, kTile) LN output
  s.o = align4(s.g + D * kTile);               // (D, kTile) attention out
  s.ff = align4(s.o + D * kTile);              // (F, kTile) MLP activation
  s.q = align4(s.ff + F * kTile);              // (qw, kTile) own q
  s.nkv = align4(s.q + qw * kTile);            // (L, 2, qw, kTile) new K/V
  s.p = align4(s.nkv + L * 2 * qw * kTile);    // (kWarps, C) softmax
  s.res = align4(s.p + kWarps * C);            // a GEMV's raw sums
  s.par = align4(s.res + res);  // LN parameters and biases
  s.total = s.par + 9 * L * D + 2 * D + L * F + s.lg_ld;
  return s;
}

// What the chain needs of a rank's shape, computed once into shared memory
// and read there where used: kept in registers across the whole step it
// would push the kernel past the 80 registers a thread that three blocks a
// SM allow.
struct Frame {
  Smem lay;
  int hd, lane0, live, h0, h1, qc0, qc1, nq, qw;
  Cols dc, fc, ac;
};

__global__ void __cluster_dims__(kRanks, 1, 1)
    __launch_bounds__(kThreads, 3) decode_step_kernel(const DecodeStepArgs a) {
  int r;  // this block's rank in its cluster
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  const int L = a.num_layers, B = a.batch, C = a.capacity, D = a.dim;
  const int H = a.num_heads, F = a.ff_dim, A = a.num_actions;
  const int tid = threadIdx.x, t = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float smem[];
  __shared__ Frame fr;
  if (tid == 0) {
    fr.lay = smem_layout(L, D, F, H, C, A);
    fr.hd = D / H;
    fr.lane0 = (blockIdx.x / kRanks) * kTile;
    fr.live = min(kTile, B - fr.lane0);  // lanes of this tile that exist
    // this rank's heads (append, q, attention) and column shares
    fr.h0 = r * H / kRanks;
    fr.h1 = (r + 1) * H / kRanks;
    fr.qc0 = fr.h0 * fr.hd;  // its q / K / V columns
    fr.qc1 = fr.h1 * fr.hd;
    fr.nq = fr.qc1 - fr.qc0;
    fr.qw = (H + kRanks - 1) / kRanks * fr.hd;  // most q columns of a rank
    fr.dc = split_cols(D, r);
    fr.fc = split_cols(F, r);
    fr.ac = split_cols(A, r);
  }
  __syncthreads();
  const Smem& lay = fr.lay;
  const int &hd = fr.hd, &lane0 = fr.lane0, &live = fr.live, &h0 = fr.h0,
            &h1 = fr.h1, &qc0 = fr.qc0, &qc1 = fr.qc1, &nq = fr.nq,
            &qw = fr.qw;
  const Cols &dc = fr.dc, &fc = fr.fc, &ac = fr.ac;
  const int nd = dc.j1 - dc.j0, nf = fc.j1 - fc.j0, na = ac.j1 - ac.j0;

  float* xs = smem + lay.xs;
  float* h = smem + lay.h;
  float* g = smem + lay.g;
  float* o = smem + lay.o;
  float* ff = smem + lay.ff;
  float* qs = smem + lay.q;
  // the appended K/V rows of the rank's heads, (L, 2, qw, kTile): the
  // attention reads them here, never back from the cache it wrote
  float* nkv = smem + lay.nkv;
  float* res = smem + lay.res;
  // fixed-size state at fixed addresses: the slices' (max, sum) and argmax
  // candidates, each lane's attended slots, append slot and temperature
  __shared__ float stats[kRanks * kTile * 2], best[kRanks * kTile * 3];
  __shared__ int nvs[kTile], slots[kTile];
  __shared__ float temps[kTile];
  // parameters read on the chain, copied in once: LN scales and biases,
  // the GEMV biases, this rank's share of b_out (sections of lay.par; the
  // offsets are recomputed from the shapes where used, which keeps the
  // kernel within its 80 registers)
  auto par = [&](Par sec) { return smem + lay.par + par_offset(sec, L, D, F); };

  // one mbarrier per exchange: o, h after proj, ff, h after ff2 (phase =
  // layer parity), the readout's (max, sum) and argmax candidates
  __shared__ uint64_t bars[6];
  uint64_t *bar_o = bars, *bar_hp = bars + 1, *bar_ff = bars + 2,
           *bar_hf = bars + 3, *bar_stats = bars + 4, *bar_best = bars + 5;
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const uint32_t vec_bytes = D * kTile * 4;  // one gathered (D, kTile)

  const Gemv kv_gm{a.kv_w, (size_t)D * 2 * D, (size_t)D, 2, 2 * L, 2 * D,
                   qc0, qc1, D};  // 2L blocks (layer, K or V) of kv_w
  float2 wv[kBatch];  // a GEMV's first weights, loaded ahead of its inputs
  gemv_first<2>(kv_gm, wv);

  // Before any block writes another's shared memory, every block of the
  // cluster must be running (its mbarriers initialised): arrive now, wait
  // before the first push.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // inputs and parameters, all copies in flight at once
  for (int idx = tid; idx < D * kTile; idx += kThreads) {
    const int i = idx / kTile, l = idx % kTile;
    if (l < live) cp_async4(xs + idx, a.x_new + (size_t)(lane0 + l) * D + i);
    cp_async4(h + idx, a.q0 + i);
  }
  for (int i = tid; i < L * D; i += kThreads) {
    cp_async4(par(kLn1s) + i, a.ln1_scale + i);
    cp_async4(par(kLn1b) + i, a.ln1_bias + i);
    cp_async4(par(kLn2s) + i, a.ln2_scale + i);
    cp_async4(par(kLn2b) + i, a.ln2_bias + i);
    cp_async4(par(kQb) + i, a.q_b + i);
    cp_async4(par(kPb) + i, a.proj_b + i);
    cp_async4(par(kF2b) + i, a.ff2_b + i);
  }
  for (int i = tid; i < 2 * L * D; i += kThreads) cp_async4(par(kKvb) + i, a.kv_b + i);
  for (int i = tid; i < L * F; i += kThreads) cp_async4(par(kF1b) + i, a.ff1_b + i);
  for (int i = tid; i < D; i += kThreads) {
    cp_async4(par(kLnfs) + i, a.lnf_scale + i);
    cp_async4(par(kLnfb) + i, a.lnf_bias + i);
  }
  for (int i = tid; i < na; i += kThreads) cp_async4(par(kBo) + i, a.b_out + ac.j0 + i);
  if (tid < kTile) {
    const bool on = tid < live;
    nvs[tid] = on ? min(a.lengths[lane0 + tid] + 1, C) : 0;  // BOS + tokens
    slots[tid] = on ? a.slot[lane0 + tid] : -1;
    temps[tid] = on && a.logit_temp ? a.logit_temp[lane0 + tid] : 1.f;
  }
  for (int idx = tid; idx < D * kTile; idx += kThreads)
    if (idx % kTile >= live) xs[idx] = 0.f;
  cp_async_wait();
  __syncthreads();

  // 1. append this rank's heads' K/V columns of every layer at slot[b]
  gemv<2>(xs, kv_gm, wv, res, kTile);
  gemv_first<2>(layer_gemv(a.q_w, 0, D, D, qc0, qc1), wv);
  __syncthreads();
  for (int idx = tid; idx < 2 * L * nq * kTile; idx += kThreads) {
    const int l = idx % kTile, col = idx / kTile;
    const int part = col / nq, j = qc0 + col % nq;  // part = layer * 2 + kv
    const float v = res[idx] + par(kKvb)[part * D + j];
    nkv[(part * qw + j - qc0) * kTile + l] = v;
    const int s = slots[l];
    if (l >= live || s < 0 || s >= C) continue;
    float* dst = part % 2 ? a.v_cache : a.k_cache;
    dst[(((size_t)(part / 2) * B + lane0 + l) * C + s) * D + j] = v;
  }
  __syncthreads();

  // 2. latent query through the layer stack
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    layernorm(h, g, par(kLn1s) + l * D, par(kLn1b) + l * D, D);
    __syncthreads();
    gemv<2>(g, layer_gemv(a.q_w, l, D, D, qc0, qc1), wv, qs, kTile);
    const Gemv proj = layer_gemv(a.proj_w, l, D, D, dc.j0, dc.j1);
    gemv_first<2>(proj, wv);
    __syncthreads();
    for (int idx = tid; idx < nq * kTile; idx += kThreads)
      qs[idx] += par(kQb)[l * D + qc0 + idx / kTile];
    __syncthreads();
    if (l == 0)  // every rank is running
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const uint32_t parity = l & 1;

    // attention of the rank's heads: a warp per (lane, head)
    for (int pair = warp; pair < kTile * (h1 - h0); pair += kWarps) {
      const int ln = pair % kTile, hh = h0 + pair / kTile;
      const int nv = nvs[ln], sl = slots[ln];
      const size_t row = ((size_t)l * B + lane0 + ln) * C;
      const float* kl = a.k_cache + row * D + hh * hd;
      const float* vl = a.v_cache + row * D + hh * hd;
      const float* kn = nkv + ((l * 2) * qw + (hh - h0) * hd) * kTile + ln;
      const float* vn = kn + qw * kTile;
      const float* qh = qs + (hh - h0) * hd * kTile + ln;
      float* p = smem + lay.p + warp * C;
      const float sqrt_hd = sqrtf((float)hd);
      float m = -FLT_MAX;
      for (int c = t; c < nv; c += 32) {
        float dot = 0.f;
        if (c == sl)
          for (int i = 0; i < hd; ++i)
            dot = fmaf(qh[i * kTile], kn[i * kTile], dot);
        else
          for (int i = 0; i < hd; ++i)
            dot = fmaf(qh[i * kTile], kl[(size_t)c * D + i], dot);
        p[c] = dot / sqrt_hd;
        m = fmaxf(m, p[c]);
      }
      m = warp_max(m);
      float den = 0.f;
      for (int c = t; c < nv; c += 32) {
        p[c] = expf(p[c] - m);
        den += p[c];
      }
      den = warp_sum(den);
      __syncwarp();
      for (int d = t; d < hd; d += 32) {
        float acc = 0.f;
        for (int c = 0; c < nv; ++c)
          acc = fmaf(p[c], c == sl ? vn[d * kTile] : vl[(size_t)c * D + d],
                     acc);
        push(o + (hh * hd + d) * kTile + ln, bar_o, acc / fmaxf(den, 1e-30f));
      }
      __syncwarp();
    }
    if (tid == 0) mbar_expect(bar_o, vec_bytes);
    mbar_wait(bar_o, parity);  // o gathered

    // h += o @ proj + b
    gemv<2>(o, proj, wv, res, kTile);
    const Gemv ff1 = layer_gemv(a.ff1_w, l, D, F, fc.j0, fc.j1);
    gemv_first<2>(ff1, wv);
    __syncthreads();
    for (int idx = tid; idx < nd * kTile; idx += kThreads) {
      const int j = dc.j0 + idx / kTile;
      float* hj = h + j * kTile + idx % kTile;
      push(hj, bar_hp, (*hj + res[idx]) + par(kPb)[l * D + j]);
    }
    if (tid == 0) mbar_expect(bar_hp, vec_bytes);
    mbar_wait(bar_hp, parity);  // h gathered

    layernorm(h, g, par(kLn2s) + l * D, par(kLn2b) + l * D, D);
    __syncthreads();
    gemv<2>(g, ff1, wv, res, kTile);
    const Gemv ff2 = layer_gemv(a.ff2_w, l, F, D, dc.j0, dc.j1);
    gemv_first<2>(ff2, wv);
    __syncthreads();
    for (int idx = tid; idx < nf * kTile; idx += kThreads) {
      const int j = fc.j0 + idx / kTile;
      push(ff + j * kTile + idx % kTile, bar_ff,
           gelu_tanh(res[idx] + par(kF1b)[l * F + j]));
    }
    if (tid == 0) mbar_expect(bar_ff, F * kTile * 4);
    mbar_wait(bar_ff, parity);  // ff gathered

    gemv<2>(ff, ff2, wv, res, kTile);
    __syncthreads();
    for (int idx = tid; idx < nd * kTile; idx += kThreads) {
      const int j = dc.j0 + idx / kTile;
      float* hj = h + j * kTile + idx % kTile;
      push(hj, bar_hf, (*hj + res[idx]) + par(kF2b)[l * D + j]);
    }
    if (l + 1 < L)
      gemv_first<2>(layer_gemv(a.q_w, l + 1, D, D, qc0, qc1), wv);
    else
      gemv_first<8>(layer_gemv(a.w_out, 0, D, A, ac.j0, ac.j1), wv);
    if (tid == 0) mbar_expect(bar_hf, vec_bytes);
    mbar_wait(bar_hf, parity);  // h gathered
  }
  layernorm(h, g, par(kLnfs), par(kLnfb), D);
  __syncthreads();
  if (r == 0)
    for (int idx = tid; idx < D * kTile; idx += kThreads) {
      const int i = idx / kTile, l = idx % kTile;
      if (l < live) a.y[(size_t)(lane0 + l) * D + i] = g[idx];
    }

  // 3. readout of the rank's A slice (raw sums, a row of kTile + 1 floats
  //    per action so the lanes' passes below meet no bank conflicts),
  //    masked log-softmax, Gumbel-max
  constexpr int kLd = kTile + 1;
  gemv<8>(g, layer_gemv(a.w_out, 0, D, A, ac.j0, ac.j1), wv, res, kLd);
  __syncthreads();
  // warp w: lane w's masked logits, their max and sum of exp
  const int b = lane0 + warp;
  float* mylg = res + warp;  // lane w's logit of action j at mylg[j * kLd]
  if (warp < live) {
    const uint8_t* mrow = a.mask + (size_t)b * A + ac.j0;
    const float temp = temps[warp];
    float m = -FLT_MAX;
    for (int j = t; j < na; j += 32) {
      const float ml = mrow[j] ? (mylg[j * kLd] + par(kBo)[j]) * temp : -FLT_MAX;
      mylg[j * kLd] = ml;
      m = fmaxf(m, ml);
    }
    m = warp_max(m);
    float se = 0.f;
    for (int j = t; j < na; j += 32) se += expf(mylg[j * kLd] - m);
    se = warp_sum(se);
    if (t == 0) {
      push(stats + (r * kTile + warp) * 2, bar_stats, m);
      push(stats + (r * kTile + warp) * 2 + 1, bar_stats, se);
    }
  }
  if (tid == 0) mbar_expect(bar_stats, kRanks * live * 2 * 4);
  mbar_wait(bar_stats, 0);  // (max, sum) of every slice
  float lse = 0.f;
  if (warp < live) {
    float m = -FLT_MAX;
    for (int q = 0; q < kRanks; ++q)
      m = fmaxf(m, stats[(q * kTile + warp) * 2]);
    float se = 0.f;
    for (int q = 0; q < kRanks; ++q)
      se += stats[(q * kTile + warp) * 2 + 1] *
            expf(stats[(q * kTile + warp) * 2] - m);
    lse = m + logf(se);
    const float* grow = a.gumbel + (size_t)b * A + ac.j0;
    float bv = -INFINITY, bx = 0.f;
    int bi = INT_MAX;
    for (int j = t; j < na; j += 32)
      arg_better(bv, bi, bx, (mylg[j * kLd] - lse) + grow[j], ac.j0 + j,
                 mylg[j * kLd]);
    for (int off = 16; off > 0; off >>= 1)
      arg_better(bv, bi, bx, __shfl_xor_sync(kFull, bv, off),
                 __shfl_xor_sync(kFull, bi, off),
                 __shfl_xor_sync(kFull, bx, off));
    if (t == 0) {
      float* dst = best + (r * kTile + warp) * 3;
      store_rank(dst, 0, bar_best, bv);
      store_rank(dst + 1, 0, bar_best, __int_as_float(bi));
      store_rank(dst + 2, 0, bar_best, bx);
    }
  }
  if (r == 0) {  // every slice's candidate
    if (tid == 0) mbar_expect(bar_best, kRanks * live * 3 * 4);
    mbar_wait(bar_best, 0);
  }
  if (r == 0 && warp < live && t == 0) {
    float bv = -INFINITY, bx = 0.f;
    int bi = INT_MAX;
    for (int q = 0; q < kRanks; ++q) {
      const float* c = best + (q * kTile + warp) * 3;
      arg_better(bv, bi, bx, c[0], __float_as_int(c[1]), c[2]);
    }
    a.action[b] = bi;
    a.log_pf[b] = bx - lse;
  }
  // no block leaves while a store into another's shared memory may be in
  // flight
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Launches one fused step on `stream`; returns a cudaError_t (0 = success).
int repro_decode_step(const DecodeStepArgs* args, void* stream) {
  const DecodeStepArgs& a = *args;
  if (a.num_layers < 1 || a.capacity < 1 || a.dim < 1 || a.num_heads < 1 ||
      a.dim % a.num_heads != 0 || a.ff_dim < 1 || a.num_actions < 1 ||
      a.batch < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  const size_t smem =
      sizeof(float) * (size_t)smem_layout(a.num_layers, a.dim, a.ff_dim,
                                          a.num_heads, a.capacity,
                                          a.num_actions)
                          .total;
  // above 48 KB of shared memory in all (the kernel's static arrays
  // included) a launch needs the opt-in
  static size_t static_bytes = ~(size_t)0;  // the same on every device
  if (static_bytes == ~(size_t)0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, decode_step_kernel);
    if (err != cudaSuccess) return (int)err;
    static_bytes = attr.sharedSizeBytes;
  }
  if (smem + static_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (a.batch + kTile - 1) / kTile;
  decode_step_kernel<<<tiles * kRanks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
