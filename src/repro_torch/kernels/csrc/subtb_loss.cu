// SubTB(lambda) loss per trajectory and its gradient, for Hopper (sm_90a).
//
// Forward replaces the TPU kernel `subtb_loss_pallas`
// (src/repro/kernels/subtb_loss.py:58, pl.pallas_call at :71) and computes
// what `ref_subtb` (kernels/ref.py) computes, in fp32: for each trajectory b
// with potentials phi_b (T+1 states) and length n = length[b],
//   loss[b] = sum_{0<=j<k<=n} lam^(k-j) (phi_j - phi_k)^2
//             / max(sum_{0<=j<k<=n} lam^(k-j), 1e-9).
// Backward has no TPU kernel (the JAX package differentiates its O(T)
// prefix recurrence, src/repro/core/objectives.py:255-277); it computes the
// same gradient in closed form, `ref_subtb_backward`:
//   dphi[b, i] = g[b] * 2 / max(den_b, 1e-9)
//                * sum_{m<=n, m!=i} lam^|i-m| (phi_i - phi_m)   for i <= n,
//   dphi[b, i] = 0                                              past n.
//
// Design: an O(T) centred decayed scan, one launch per call.  The pair sum
// needs only, for each state k, the decayed weight W_k = sum_{j<k}
// lam^(k-j), the W-weighted mean M_k of phi_j over j < k and the weighted
// sum of squared deviations Q_k about M_k:
//   sum_{j<k} lam^(k-j) (phi_j - phi_k)^2 = Q_k + W_k (phi_k - M_k)^2,
// so num = sum_{k=1..n} Q_k + W_k (phi_k - M_k)^2 and den = sum_k W_k; the
// gradient's sum over m is W^L_i (phi_i - M^L_i) + W^R_i (phi_i - M^R_i),
// the same triple (without Q) taken from the left and from the right.  A
// segment's summary (W, M, Q) keeps its weights decayed to its end; two
// segments A then B merge by decaying A by lam^(length of B) and Chan's
// rule with delta = M_B - M_A: W = W_A + W_B, M = M_A + delta W_B / W,
// Q = Q_A + Q_B + delta^2 W_A W_B / W.  The merge is associative, so the
// prefixes come from a scan in a fixed tree order.  It is centred (no
// sum of phi^2 that cancels, as JAX's expanded S2 - 2 phi S1 + phi^2 W
// does at a large common offset of phi, which log Z alone sets), and every
// state is first shifted by the trajectory's phi_0: differences of nearby
// fp32 values are exact, and the means stay small.
//
// Layout.  Where T+1 <= 32 (the hypergrid recipe's 30 states), a warp per
// trajectory, four to a block: lane k holds state k - 1, and a 5-round
// shuffle scan gives lane k the prefix over states < k (the right-hand
// scan for the backward runs the other way in the same rounds).  Above
// that, a block per trajectory of ~T+1 / kRun threads (at most 1,024):
// each thread loads a run of min(ceil((n+1) / threads), kRun) states into
// registers at once and folds it serially, the block scans the runs'
// summaries (a warp scan, the warps' totals through shared memory, a warp
// scan of those in every warp: one barrier), and each thread walks its
// run again from its prefix.  A trajectory longer than kRun states a
// thread goes in tiles of that many, a carry merged from tile to tile.
// The backward takes a pass from the right (each state's right half,
// kept in its output entry, and den = sum_i W^R_i, the same pairs as
// sum_k W^L_k), then one from the left.  Runs, like states, have one
// length, so lam^(span) is exp2f(span * log2 lam) per round, off the
// data's critical path.  phi is read through its (B, T+1) strides (the
// loss passes a transposed time-major view); the warp layout loads all
// T+1 states and masks those past n, the block layout reads none past n.
// No scratch, no atomics: the order of every sum is fixed by T+1 and n,
// so two calls agree bit for bit.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  The
// function needs O(n) work: phi read once, ~20 FLOP a state forward and
// ~40 backward.  At the training shape (B = 16, T+1 = 30) that is 1.9 KB
// and ~10 kFLOP, under 1 ns either way, so the kernel is bound by launch
// latency and the scan's chain of dependent shuffles; at (3, 7000) by the
// chain of a run's serial merges, the block scan's rounds and barrier.
#include <cuda_runtime.h>

#include <cstdint>

// Kernel operands; mirrored field for field by `SubtbArgs` in build.py.
// Strides are in elements.
struct SubtbArgs {
  const float* phi;      // (B, T+1), strides (phi_sb, phi_st)
  const int32_t* length; // (B,) contiguous, 0 <= length <= T
  const float* g;        // (B,) contiguous cotangent; backward only
  float* loss;           // (B,) forward output
  float* dphi;           // (B, T+1) contiguous backward output
  long long phi_sb, phi_st;
  float lam;
  int batch, states, device;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
// trajectories per block where T+1 <= 32 (a warp each)
constexpr int kWarpRows = 4;
// states per thread the block layout aims at, its largest block, and the
// steps of a run taken without a branch
constexpr int kRun = 8;
constexpr int kMaxThreads = 1024;
constexpr int kGroup = 4;

// A segment's decayed weight, weighted mean and weighted sum of squared
// deviations, weights decayed to the segment's end.  W = 0 is the empty
// segment (M = Q = 0).
struct Seg {
  float w, m, q;
};

// Segment a followed by segment b; `decay` = lam^(length of b).  An empty
// b (W = 0) leaves a's M and Q as they are (r = 0); an empty a gives b's,
// to the division's 2 ulp; a W = 0 is never divided by.
template <bool kQ>
__device__ __forceinline__ Seg merge(Seg a, Seg b, float decay) {
  const float wa = a.w * decay;
  const float w = wa + b.w;
  // 2 ulp, and never the IEEE division's slow path (taken for a 0 or a
  // subnormal divisor, as the empty segments give)
  const float r = w > 0.f ? __fdividef(b.w, w) : 0.f;
  const float d = b.m - a.m;
  return Seg{w, a.m + d * r, kQ ? a.q * decay + b.q + d * d * wa * r : 0.f};
}

// s followed by one state x, decayed to the position after x.  W + 1 >= 1,
// so the approximate reciprocal needs no range handling.
template <bool kQ>
__device__ __forceinline__ Seg append(Seg s, float x, float lam) {
  const float w1 = s.w + 1.f;
  float r;  // 1 / w1 to 1 ulp, one instruction
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(w1));
  const float d = x - s.m;
  return Seg{lam * w1, s.m + d * r, kQ ? lam * (s.q + d * d * s.w * r) : 0.f};
}

// lam^x from log2 lam (exact 1 at lam = 1)
__device__ __forceinline__ float lam_pow(float x, float log2_lam) {
  return exp2f(x * log2_lam);
}

template <bool kQ>
__device__ __forceinline__ Seg shfl_up(Seg s, int o) {
  return Seg{__shfl_up_sync(kFull, s.w, o), __shfl_up_sync(kFull, s.m, o),
             kQ ? __shfl_up_sync(kFull, s.q, o) : 0.f};
}

template <bool kQ>
__device__ __forceinline__ Seg shfl_down(Seg s, int o) {
  return Seg{__shfl_down_sync(kFull, s.w, o), __shfl_down_sync(kFull, s.m, o),
             kQ ? __shfl_down_sync(kFull, s.q, o) : 0.f};
}

template <bool kQ>
__device__ __forceinline__ Seg shfl_idx(Seg s, int src) {
  return Seg{__shfl_sync(kFull, s.w, src), __shfl_sync(kFull, s.m, src),
             kQ ? __shfl_sync(kFull, s.q, src) : 0.f};
}

// Inclusive scan over the warp's lanes, left to right: lane l ends with
// lanes [0, l] merged.  Each lane's element spans `span` states, so a
// round at offset o decays the earlier part by lam^(o span).
template <bool kQ>
__device__ __forceinline__ Seg warp_scan_left(Seg s, float span,
                                              float log2_lam) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg p = shfl_up<kQ>(s, o);
    const Seg c = merge<kQ>(p, s, lam_pow(o * span, log2_lam));
    if (lane >= o) s = c;
  }
  return s;
}

// The same from the right: lane l ends with lanes [l, 31] merged, weights
// decayed towards the left.
template <bool kQ>
__device__ __forceinline__ Seg warp_scan_right(Seg s, float span,
                                               float log2_lam) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg p = shfl_down<kQ>(s, o);
    const Seg c = merge<kQ>(p, s, lam_pow(o * span, log2_lam));
    if (lane + o < 32) s = c;
  }
  return s;
}

// Warp-wide sum in a fixed order; every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The trajectory's length, clamped to [0, T].
__device__ __forceinline__ int length_of(const SubtbArgs& a, int b) {
  return min(max(a.length[b], 0), a.states - 1);
}

// ---- warp layout: T+1 <= 32, lane = state ----------------------------------

__global__ void __launch_bounds__(32 * kWarpRows)
    subtb_fwd_warp(const SubtbArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (b >= a.batch) return;  // a whole warp leaves together
  const float* row = a.phi + b * a.phi_sb;
  const int n = length_of(a, b);
  const float log2_lam = log2f(a.lam);
  // the row's loads do not wait for the length (states past n are masked)
  const float p0 = row[0];
  const float raw = lane < a.states ? row[lane * a.phi_st] : 0.f;
  const float x = lane <= n ? raw - p0 : 0.f;
  // lane k holds state k - 1, so the inclusive scan is the prefix over
  // states < k
  const float xp = __shfl_up_sync(kFull, x, 1);
  Seg s = lane >= 1 && lane <= n ? Seg{a.lam, xp, 0.f} : Seg{0.f, 0.f, 0.f};
  s = warp_scan_left<true>(s, 1.f, log2_lam);
  const float d = x - s.m;
  const float num = warp_sum(lane <= n ? s.q + s.w * d * d : 0.f);
  const float den = warp_sum(lane <= n ? s.w : 0.f);
  if (lane == 0) a.loss[b] = num / fmaxf(den, 1e-9f);
}

__global__ void __launch_bounds__(32 * kWarpRows)
    subtb_bwd_warp(const SubtbArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (b >= a.batch) return;
  const float* row = a.phi + b * a.phi_sb;
  const int n = length_of(a, b);
  const float log2_lam = log2f(a.lam);
  const float p0 = row[0], gb = a.g[b];
  const float raw = lane < a.states ? row[lane * a.phi_st] : 0.f;
  const float x = lane <= n ? raw - p0 : 0.f;
  const float xl = __shfl_up_sync(kFull, x, 1);
  const float xr = __shfl_down_sync(kFull, x, 1);
  const Seg none{0.f, 0.f, 0.f};
  // left: lane k holds state k - 1; right: lane k holds state k + 1
  Seg l = lane >= 1 && lane <= n ? Seg{a.lam, xl, 0.f} : none;
  Seg r = lane + 1 <= n ? Seg{a.lam, xr, 0.f} : none;
  l = warp_scan_left<false>(l, 1.f, log2_lam);
  r = warp_scan_right<false>(r, 1.f, log2_lam);
  const float den = warp_sum(lane <= n ? l.w : 0.f);
  const float scale = 2.f * gb / fmaxf(den, 1e-9f);
  const float v = l.w * (x - l.m) + r.w * (x - r.m);
  if (lane < a.states)
    a.dphi[(size_t)b * a.states + lane] = lane <= n ? scale * v : 0.f;
}

// ---- block layout: T+1 > 32, a block per trajectory, a run per thread ------

// One direction's scan over the block's runs, given each thread's run
// summary: returns the thread's exclusive part (the runs before it, or
// after it where kRight), each span decayed by lam^(its length), and sets
// `tile` to all runs merged.  Every run before a nonempty run is full
// (`span` states), and so is every run between a nonempty suffix and this
// one, so each round's decay is lam^(o span); what a partial or empty run
// gives a later one is never read, and the left total is read only for a
// full tile.  Over several warps, warp 0 scans the warps' totals between
// two barriers; `totals` holds 33.
template <bool kQ, bool kRight>
__device__ __forceinline__ Seg block_scan(Seg s, float span, float log2_lam,
                                          Seg* totals, Seg& tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Seg none{0.f, 0.f, 0.f};
  constexpr int kLast = kRight ? 0 : 31;  // the lane holding the warp's total
  s = kRight ? warp_scan_right<kQ>(s, span, log2_lam)
             : warp_scan_left<kQ>(s, span, log2_lam);
  Seg ex = kRight ? shfl_down<kQ>(s, 1) : shfl_up<kQ>(s, 1);
  if (lane == 31 - kLast) ex = none;
  if (nwarps == 1) {
    tile = shfl_idx<kQ>(s, kLast);
    return ex;
  }
  if (lane == kLast) totals[warp] = s;
  __syncthreads();
  if (warp == 0) {  // warp w's exclusive part into totals[w], the tile's
                    // into totals[32]
    Seg t = lane < nwarps ? totals[lane] : none;
    t = kRight ? warp_scan_right<kQ>(t, 32.f * span, log2_lam)
               : warp_scan_left<kQ>(t, 32.f * span, log2_lam);
    Seg e = kRight ? shfl_down<kQ>(t, 1) : shfl_up<kQ>(t, 1);
    if (kRight ? lane + 1 >= nwarps : lane == 0) e = none;
    const Seg all = shfl_idx<kQ>(t, kRight ? 0 : nwarps - 1);
    if (lane < nwarps) totals[lane] = e;
    if (lane == 0) totals[32] = all;
  }
  __syncthreads();
  tile = totals[32];
  return merge<kQ>(totals[warp], ex,
                   lam_pow((kRight ? 31 - lane : lane) * span, log2_lam));
}

// Block-wide sums of two values in a fixed order (warp butterflies, then a
// butterfly over the warps' sums); every thread gets them.
__device__ __forceinline__ void block_sum2(float& u, float& v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u = warp_sum(u);
  v = warp_sum(v);
  if (nwarps == 1) return;
  if (lane == 0) {
    red[warp] = u;
    red[32 + warp] = v;
  }
  __syncthreads();
  u = warp_sum(lane < nwarps ? red[lane] : 0.f);
  v = warp_sum(lane < nwarps ? red[32 + lane] : 0.f);
}

// States 0..n go in tiles of `tile` = len * threads states, each thread a
// run of `len` = min(ceil((n+1) / threads), kRun) states of a tile: one
// tile up to kRun * threads states (8,192 at 1,024 threads), several above,
// merged through a carry.
struct Tiles {
  int len, tile;
};

__device__ __forceinline__ Tiles tiles_of(int n) {
  const int len = min((n + (int)blockDim.x) / (int)blockDim.x, kRun);
  return Tiles{len, len * (int)blockDim.x};
}

// A tile goes through shared memory: loads and stores of consecutive
// states by consecutive threads, and each thread's run read from a skewed
// layout (a word of padding every 32: runs of 8 hit 32 banks).
constexpr int kStage = kRun * kMaxThreads + kRun * kMaxThreads / 32;

__device__ __forceinline__ int skew(int k) { return k + (k >> 5); }

// The thread's run of the tile from t0: [j0, j1) of states 0..n.
struct Run {
  int j0, j1;
};

__device__ __forceinline__ Run run_of(int t0, Tiles g, int n) {
  const int j0 = min(t0 + (int)threadIdx.x * g.len, n + 1);
  return Run{j0, min(j0 + g.len, n + 1)};
}

// States [t0, end) of the row, shifted by p0, into the stage; a barrier;
// then the thread's run of them into registers (0 past it).
__device__ __forceinline__ void stage_in(float* stage, const float* row,
                                         long long st, float p0, int t0,
                                         int end, Run r, float (&x)[kRun]) {
  // at most kRun states a thread: every load in flight before any store
  float v[kRun];
#pragma unroll
  for (int c = 0; c < kRun; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    v[c] = k < end - t0 ? row[(t0 + k) * st] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kRun; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (k < end - t0) stage[skew(k)] = v[c] - p0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    x[i] = r.j0 + i < r.j1 ? stage[skew(r.j0 - t0 + i)] : 0.f;
}

// The thread's run of values v into the stage (whose reads a barrier
// since has ordered: block_scan's, or for one warp this __syncwarp), a
// barrier, then states [t0, end) of the stage to out.
__device__ __forceinline__ void stage_out(float* stage, float* out, int t0,
                                          int end, Run r,
                                          const float (&v)[kRun]) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (r.j0 + i < r.j1) stage[skew(r.j0 - t0 + i)] = v[i];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kRun; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (k < end - t0) out[t0 + k] = stage[skew(k)];
  }
}

// The run's summaries, folded left to right (weights decayed past its
// end) or right to left (decayed before its start).  Groups of kGroup
// steps are branch-free (a step past the run keeps s), so a step's W and
// 1 / (W + 1), which do not depend on phi, issue ahead of the chain
// through M and Q; a group wholly past the run is skipped.
template <bool kQ>
__device__ __forceinline__ Seg fold_left(const float (&x)[kRun], int len,
                                         float lam) {
  Seg s{0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kRun; c += kGroup) {
    if (c >= len) break;
#pragma unroll
    for (int i = c; i < c + kGroup; ++i) {
      const Seg t = append<kQ>(s, x[i], lam);
      s = i < len ? t : s;
    }
  }
  return s;
}

__device__ __forceinline__ Seg fold_right(const float (&x)[kRun], int len,
                                          float lam) {
  Seg s{0.f, 0.f, 0.f};
#pragma unroll
  for (int c = kRun - kGroup; c >= 0; c -= kGroup) {
    if (c >= len) continue;
#pragma unroll
    for (int i = c + kGroup - 1; i >= c; --i) {
      const Seg t = append<false>(s, x[i], lam);
      s = i < len ? t : s;
    }
  }
  return s;
}

__global__ void __launch_bounds__(kMaxThreads)
    subtb_fwd_block(const SubtbArgs a) {
  __shared__ float stage[kStage];
  __shared__ Seg totals[33];
  __shared__ float red[64];
  const int b = blockIdx.x;
  const float* row = a.phi + b * a.phi_sb;
  const int n = length_of(a, b);
  const Tiles g = tiles_of(n);
  const float lam = a.lam, log2_lam = log2f(lam);
  const float p0 = row[0];
  Seg carry{0.f, 0.f, 0.f};  // states before the tile
  float num = 0.f, den = 0.f;
  for (int t0 = 0; t0 <= n; t0 += g.tile) {
    const Run r = run_of(t0, g, n);
    float x[kRun];
    stage_in(stage, row, a.phi_st, p0, t0, min(t0 + g.tile, n + 1), r, x);
    Seg tile;
    const int len = r.j1 - r.j0;
    Seg s = block_scan<true, false>(fold_left<true>(x, len, lam),
                                    (float)g.len, log2_lam, totals, tile);
    s = merge<true>(carry, s, lam_pow((float)(r.j0 - t0), log2_lam));
    carry = merge<true>(carry, tile, lam_pow((float)g.tile, log2_lam));
    // walk the run from its prefix (state 0: the empty prefix, term 0);
    // steps past the run add nothing
#pragma unroll
    for (int c = 0; c < kRun; c += kGroup) {
      if (c >= len) break;
#pragma unroll
      for (int i = c; i < c + kGroup; ++i) {
        const float d = x[i] - s.m;
        num += i < len ? s.q + s.w * d * d : 0.f;
        den += i < len ? s.w : 0.f;
        s = append<true>(s, x[i], lam);
      }
    }
    if (t0 + g.tile <= n) __syncthreads();  // stage and totals are reused
  }
  block_sum2(num, den, red);
  if (threadIdx.x == 0) a.loss[b] = num / fmaxf(den, 1e-9f);
}

// Two passes over the tiles: from the right, each state's right half
// W^R (phi - M^R) and den = sum_i W^R_i (the same pairs as sum_k W^L_k);
// then from the left, the left half, and the sum scaled by 2 g / den.  In
// one tile the run and its right halves stay in registers between the
// passes; over several, the halves go to the output row and come back.
__global__ void __launch_bounds__(kMaxThreads)
    subtb_bwd_block(const SubtbArgs a) {
  __shared__ float stage[kStage];
  __shared__ Seg totals[33];
  __shared__ float red[64];
  const int b = blockIdx.x;
  const float* row = a.phi + b * a.phi_sb;
  const int n = length_of(a, b);
  const Tiles g = tiles_of(n);
  const bool multi = g.tile <= n;
  const float lam = a.lam, log2_lam = log2f(lam);
  const float p0 = row[0], gb = a.g[b];
  float* out = a.dphi + (size_t)b * a.states;
  float x[kRun], half[kRun];
  Seg carry{0.f, 0.f, 0.f};  // states after the tile
  float den = 0.f, unused = 0.f;
  for (int t0 = n / g.tile * g.tile; t0 >= 0; t0 -= g.tile) {
    const Run r = run_of(t0, g, n);
    const int end = min(t0 + g.tile, n + 1);
    stage_in(stage, row, a.phi_st, p0, t0, end, r, x);
    Seg tile;
    const int len = r.j1 - r.j0;
    Seg s = block_scan<false, true>(fold_right(x, len, lam), (float)g.len,
                                    log2_lam, totals, tile);
    s = merge<false>(carry, s, lam_pow((float)(end - r.j1), log2_lam));
    carry = merge<false>(carry, tile, lam_pow((float)(end - t0), log2_lam));
#pragma unroll
    for (int c = kRun - kGroup; c >= 0; c -= kGroup) {
      if (c >= len) continue;
#pragma unroll
      for (int i = c + kGroup - 1; i >= c; --i) {
        half[i] = s.w * (x[i] - s.m);
        den += i < len ? s.w : 0.f;
        const Seg t = append<false>(s, x[i], lam);
        s = i < len ? t : s;  // the walk starts at the run's last state
      }
    }
    if (multi) {
      stage_out(stage, out, t0, end, r, half);
      __syncthreads();  // stage and totals are reused
    }
  }
  block_sum2(den, unused, red);
  const float scale = 2.f * gb / fmaxf(den, 1e-9f);
  carry = Seg{0.f, 0.f, 0.f};  // states before the tile
  for (int t0 = 0; t0 <= n; t0 += g.tile) {
    const Run r = run_of(t0, g, n);
    const int end = min(t0 + g.tile, n + 1);
    if (multi) {
      stage_in(stage, row, a.phi_st, p0, t0, end, r, x);
      __syncthreads();
      stage_in(stage, out, 1, 0.f, t0, end, r, half);
    }
    Seg tile;
    const int len = r.j1 - r.j0;
    Seg s = block_scan<false, false>(fold_left<false>(x, len, lam),
                                     (float)g.len, log2_lam, totals, tile);
    s = merge<false>(carry, s, lam_pow((float)(r.j0 - t0), log2_lam));
    carry = merge<false>(carry, tile, lam_pow((float)g.tile, log2_lam));
#pragma unroll
    for (int c = 0; c < kRun; c += kGroup) {
      if (c >= len) break;
#pragma unroll
      for (int i = c; i < c + kGroup; ++i) {
        half[i] = scale * (half[i] + s.w * (x[i] - s.m));
        s = append<false>(s, x[i], lam);
      }
    }
    stage_out(stage, out, t0, end, r, half);
    if (t0 + g.tile <= n) __syncthreads();  // stage and totals are reused
  }
  for (int j = n + 1 + threadIdx.x; j < a.states; j += blockDim.x)
    out[j] = 0.f;
}

int check(const SubtbArgs& a) {
  if (a.batch < 0 || a.states < 1 || !(a.lam > 0.f && a.lam <= 1.f))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(a.device);
}

// Threads of the block layout: about kRun states a thread at full length.
int block_threads(int states) {
  const int warps = (states + 32 * kRun - 1) / (32 * kRun);
  return 32 * (warps < kMaxThreads / 32 ? warps : kMaxThreads / 32);
}

template <typename Warp, typename Block>
int launch(const SubtbArgs& a, void* stream, Warp warp_kernel,
           Block block_kernel) {
  int err = check(a);
  if (err != 0 || a.batch == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.states <= 32)
    warp_kernel<<<(a.batch + kWarpRows - 1) / kWarpRows, 32 * kWarpRows, 0,
                  s>>>(a);
  else
    block_kernel<<<a.batch, block_threads(a.states), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward on `stream`: loss.  Returns a cudaError_t.
int repro_subtb_fwd(const SubtbArgs* args, void* stream) {
  return launch(*args, stream, subtb_fwd_warp, subtb_fwd_block);
}

// Backward on `stream`: dphi.  Returns a cudaError_t.
int repro_subtb_bwd(const SubtbArgs* args, void* stream) {
  return launch(*args, stream, subtb_bwd_warp, subtb_bwd_block);
}

}  // extern "C"
