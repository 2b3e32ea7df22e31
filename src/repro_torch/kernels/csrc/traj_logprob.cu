// Trajectory log-probabilities and their gradient, for Hopper (sm_90a).
//
// Forward replaces the TPU kernel `traj_logprob_pallas`
// (src/repro/kernels/traj_logprob.py:61, pl.pallas_call at :87) and
// computes what `ref_traj_logprob` (kernels/ref.py) computes, in fp32: per
// row (b, t) of logits (B, T, A), the masked logits (illegal -> -FLT_MAX),
// their logsumexp, and
//   per_step[b, t] = valid[b, t] ? masked[action[b, t]] - lse : 0,
//   total[b]       = sum_t per_step[b, t].
// Backward has no TPU kernel (the JAX package's VJP is jnp,
// src/repro/kernels/ops.py:130-138); it computes
// `ref_traj_logprob_backward`'s closed form in one pass per row:
//   d[b, t, :] = (g_total[b] + g_step[b, t]) * valid * (onehot - softmax).
//
// Design.  Forward: one launch, one block per (b, t) row.  Where the row's
// logits and mask start on 16-byte boundaries and A % 16 == 0 (the training
// path's rows at A = 3840), each thread reads 16-element units of the row
// with 16-byte loads (four float4 of logits, one uint4 of mask bytes) and
// keeps them in registers: 2 units a thread at 128 threads, so a chunk of
// up to 4,096 elements is read once; the row max, then the sum of exp from
// those registers (one expf per element, no per-element rescale); a longer
// row folds its chunks into the (max, sum) pair once per chunk.  Other rows
// (A = 15, 203, misaligned views) take a scalar path in the same kernel:
// max, then sum of exp, over strided 4-byte loads.  The total of trajectory
// b is summed over t in order of t by the block that finishes its last row:
// each row's thread 0 writes per_step and counts itself in an int32 arrival
// counter per trajectory (a scratch buffer the wrapper keeps per device,
// zero between launches) with an acquire-release atomic; the block that
// brings it to T sums per_step[b, :] and returns the counter to 0.  No
// float atomics, so two runs agree bit for bit.
//
// Backward: one launch, one block per (b, t) row, the same two paths.  On
// the 16-byte path (the output row on a 16-byte boundary too) a row of up
// to 4,096 elements is read once into registers by the forward's loads;
// its max and its sum of exp are block reductions over those registers
// (each expf kept in place of its logit), and the gradient row goes out
// from the same registers in float4 stores: one read, one write.  A longer
// row takes the forward's (max, sum) over its chunks, then reads each
// chunk again to write it.  The scalar path takes a max pass, a sum pass
// and a write pass over strided loads.  Thread 0 reads the step's valid
// flag, action and cotangents while the row's loads are in flight; the
// first reduction's barriers hand them to the block.  A dead row
// (coefficient 0) is computed like any other: its zeros are 0 * (onehot -
// p), as in the plain version, which a shortcut that skipped the read
// would not match on a row holding an inf or a NaN.
//
// Logits, mask, actions and valid are read through their (B, T) strides
// with a unit stride along A, so the transposed time-major views of the
// training path need no copy.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  At the
// training shape (16, 15, 3840) the forward must read 3.7 MB of logits and
// 0.9 MB of mask, about 1.4 us at the memory rate; the backward reads the
// same and writes 3.7 MB, about 2.5 us.  About 5 fp32 operations per element
// put the operation bound two orders lower: both are bound by bytes.
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

// Kernel operands; mirrored field for field by `TrajLogprobArgs` in
// build.py.  Strides are in elements.
struct TrajLogprobArgs {
  const float* logits;      // (B, T, A), strides (logits_sb, logits_st, 1)
  const uint8_t* mask;      // (B, T, A) bool, strides (mask_sb, mask_st, 1)
  const int64_t* actions;   // (B, T), strides (actions_sb, actions_st)
  const uint8_t* valid;     // (B, T) bool, strides (valid_sb, valid_st)
  const float* g_total;     // (B,) contiguous; backward only
  const float* g_step;      // (B, T), strides (g_step_sb, g_step_st)
  float* total;             // (B,) forward output
  float* per_step;          // (B, T) contiguous forward output
  float* dlogits;           // (B, T, A) contiguous backward output
  int* arrivals;            // (B,) int32 scratch, zero; forward only
  long long logits_sb, logits_st, mask_sb, mask_st, actions_sb, actions_st;
  long long valid_sb, valid_st, g_step_sb, g_step_st;
  int batch, steps, num_actions, device;
};

namespace {

constexpr int kMaxWarps = 8;

// Merge (m2, s2) into (m, s).  m = -inf only for a pair that folded nothing.
__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  if (m2 > m) {
    const float tm = m, ts = s;
    m = m2;
    s = s2;
    m2 = tm;
    s2 = ts;
  }
  if (m2 != -INFINITY) s += s2 * expf(m2 - m);
}

__device__ __forceinline__ float masked_at(const float* x, const uint8_t* mk,
                                           int j) {
  return mk[j] ? x[j] : -FLT_MAX;
}

// threads of the 16-byte path, and the elements a chunk holds in registers
constexpr int kVecThreads = 128;
constexpr int kUnit = 16;                  // elements per 16-byte mask load
constexpr int kUnitsPerThread = 2;
constexpr int kChunk = kVecThreads * kUnit * kUnitsPerThread;  // 4,096

// Block-wide max; every thread gets it.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free (an earlier reduction has read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  return v;
}

// Block-wide sum, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v += red[w];
  return v;
}

// One chunk of a row, read with 16-byte loads into registers: n elements
// from x / mk, n % 16 == 0, both 16-byte aligned; masked entries at
// -FLT_MAX, the pads past n at -inf.
__device__ __forceinline__ void load_chunk_vec(
    const float* x, const uint8_t* mk, int n,
    float (&v)[kUnitsPerThread][kUnit]) {
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u) {
    const int e = (threadIdx.x + u * kVecThreads) * kUnit;
    if (e < n) {
      const uint4 mb = *reinterpret_cast<const uint4*>(mk + e);
      const uint32_t words[4] = {mb.x, mb.y, mb.z, mb.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(x + e + 4 * q);
        const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][4 * q + i] = ((words[q] >> (8 * i)) & 0xffu) ? fs[i] : -FLT_MAX;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kUnit; ++i) v[u][i] = -INFINITY;
    }
  }
}

// The chunk's max over the block; every thread gets it.
__device__ __forceinline__ float chunk_max(
    const float (&v)[kUnitsPerThread][kUnit], float* red) {
  float cm = -INFINITY;
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
    for (int i = 0; i < kUnit; ++i) cm = fmaxf(cm, v[u][i]);
  return block_max(cm, red);
}

// (max, sum of exp) of one chunk of a row, folded into (m, s).
__device__ void chunk_pair_vec(const float* x, const uint8_t* mk, int n,
                               float& m, float& s, float* red) {
  float v[kUnitsPerThread][kUnit];
  load_chunk_vec(x, mk, n, v);
  const float cm = chunk_max(v, red);
  float cs = 0.f;
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
    for (int i = 0; i < kUnit; ++i) cs += expf(v[u][i] - cm);  // pads: 0
  cs = block_sum(cs, red);
  online_merge(m, s, cm, cs);
}

// Whether a row takes the 16-byte path: A % 16 == 0 and its logits and
// mask start on 16-byte boundaries.
__device__ __forceinline__ bool vec_row(const float* x, const uint8_t* mk,
                                        int A) {
  return (A % kUnit) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(mk) & 15) == 0;
}

__global__ void __launch_bounds__(kVecThreads)
    traj_logprob_fwd_kernel(const TrajLogprobArgs a) {
  __shared__ float red[kMaxWarps];
  const int T = a.steps, A = a.num_actions;
  if (T == 0) {  // empty trajectories: total 0, one block per b
    if (threadIdx.x == 0) a.total[blockIdx.x] = 0.f;
    return;
  }
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  const float* x = a.logits + b * a.logits_sb + t * a.logits_st;
  const uint8_t* mk = a.mask + b * a.mask_sb + t * a.mask_st;
  // thread 0 reads the step's action and its masked logit up front, so
  // those loads overlap the row's
  float lpa = 0.f;  // an action outside [0, A), or a dead step: 0
  bool taken = false;
  if (threadIdx.x == 0) {
    const int64_t act = a.actions[b * a.actions_sb + t * a.actions_st];
    taken = a.valid[b * a.valid_sb + t * a.valid_st] != 0 && act >= 0 &&
            act < A;
    if (taken) lpa = masked_at(x, mk, (int)act);
  }
  float m = -INFINITY, s = 0.f;
  if (vec_row(x, mk, A)) {
    for (int c = 0; c < A; c += kChunk)
      chunk_pair_vec(x + c, mk + c, min(kChunk, A - c), m, s, red);
  } else {  // scalar path: max, then sum of exp, over strided loads
    float cm = -INFINITY;
    for (int j = threadIdx.x; j < A; j += blockDim.x)
      cm = fmaxf(cm, masked_at(x, mk, j));
    m = block_max(cm, red);
    float cs = 0.f;
    for (int j = threadIdx.x; j < A; j += blockDim.x)
      cs += expf(masked_at(x, mk, j) - m);
    s = block_sum(cs, red);
  }
  if (threadIdx.x == 0) {
    if (taken) lpa -= m + logf(s);
    a.per_step[(size_t)b * T + t] = lpa;
    // count this row in; release: the per_step store is visible to the
    // block that counts T, which acquires the other rows' stores
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(a.arrivals + b)
                 : "memory");
    // the block that finishes trajectory b's last row sums it, in order of
    // t (loads issued eight at a time)
    if (before == T - 1) {
      const volatile float* row = a.per_step + (size_t)b * T;
      float acc = 0.f;
      int i = 0;
      for (; i + 8 <= T; i += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = row[i + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += v[j];
      }
      for (; i < T; ++i) acc += row[i];
      a.total[b] = acc;
      a.arrivals[b] = 0;  // ready for the next launch
    }
  }
}

// Writes a chunk's gradient, coeff * (onehot(act) - e * inv_s), from the
// exps in e: n elements from out, which starts at element c of the row.
__device__ __forceinline__ void store_chunk_vec(
    float* out, int n, int c, const float (&e)[kUnitsPerThread][kUnit],
    int act, float coeff, float inv_s) {
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u) {
    const int j = (threadIdx.x + u * kVecThreads) * kUnit;
    if (j < n) {
      float o[kUnit];
#pragma unroll
      for (int i = 0; i < kUnit; ++i)
        o[i] = coeff * ((c + j + i == act ? 1.f : 0.f) - e[u][i] * inv_s);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(out + j + 4 * q) =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  }
}

__global__ void traj_logprob_bwd_kernel(const TrajLogprobArgs a) {
  __shared__ float red[kMaxWarps];
  __shared__ float s_coeff;
  __shared__ int s_act;
  const int T = a.steps, A = a.num_actions;
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  const float* x = a.logits + b * a.logits_sb + t * a.logits_st;
  const uint8_t* mk = a.mask + b * a.mask_sb + t * a.mask_st;
  float* out = a.dlogits + ((size_t)b * T + t) * A;
  // the step's scalars, read while the row's loads are in flight; the
  // first block reduction's barriers publish them
  if (threadIdx.x == 0) {
    const bool live = a.valid[b * a.valid_sb + t * a.valid_st] != 0;
    s_coeff = (a.g_total[b] + a.g_step[b * a.g_step_sb + t * a.g_step_st]) *
              (live ? 1.f : 0.f);
    const int64_t act = a.actions[b * a.actions_sb + t * a.actions_st];
    s_act = act >= 0 && act < A ? (int)act : -1;  // outside: no onehot
  }
  if (vec_row(x, mk, A) && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    float v[kUnitsPerThread][kUnit];
    if (A <= kChunk) {  // one read: the row stays in registers
      load_chunk_vec(x, mk, A, v);
      const float m = chunk_max(v, red);
      float cs = 0.f;
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
        for (int i = 0; i < kUnit; ++i) {
          v[u][i] = expf(v[u][i] - m);  // pads: 0
          cs += v[u][i];
        }
      const float inv_s = 1.f / block_sum(cs, red);
      store_chunk_vec(out, A, 0, v, s_act, s_coeff, inv_s);
      return;
    }
    float m = -INFINITY, s = 0.f;
    for (int c = 0; c < A; c += kChunk)
      chunk_pair_vec(x + c, mk + c, min(kChunk, A - c), m, s, red);
    const float inv_s = 1.f / s;
    for (int c = 0; c < A; c += kChunk) {
      const int n = min(kChunk, A - c);
      load_chunk_vec(x + c, mk + c, n, v);
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
        for (int i = 0; i < kUnit; ++i) v[u][i] = expf(v[u][i] - m);
      store_chunk_vec(out + c, n, c, v, s_act, s_coeff, inv_s);
    }
    return;
  }
  // scalar path: max, sum of exp, then the write, over strided loads
  float cm = -INFINITY;
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    cm = fmaxf(cm, masked_at(x, mk, j));
  const float m = block_max(cm, red);
  float cs = 0.f;
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    cs += expf(masked_at(x, mk, j) - m);
  const float inv_s = 1.f / block_sum(cs, red);
  const int act = s_act;
  const float coeff = s_coeff;
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    out[j] = coeff * ((j == act ? 1.f : 0.f) -
                      expf(masked_at(x, mk, j) - m) * inv_s);
}

int threads_for(int A) {
  if (A <= 32) return 32;
  if (A <= 1024) return 128;
  return 32 * kMaxWarps;
}

int check(const TrajLogprobArgs& a) {
  if (a.batch < 0 || a.steps < 0 || a.num_actions < 1)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(a.device);
}

}  // namespace

extern "C" {

// Forward on `stream`: per_step and total in one launch.  `arrivals` must
// hold B zeros (the kernel leaves them so).  Returns a cudaError_t.
int repro_traj_logprob_fwd(const TrajLogprobArgs* args, void* stream) {
  const TrajLogprobArgs& a = *args;
  int err = check(a);
  if (err != 0) return err;
  if (a.batch == 0) return 0;
  if (a.arrivals == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks =
      a.steps > 0 ? (long long)a.batch * a.steps : (long long)a.batch;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  traj_logprob_fwd_kernel<<<(unsigned)blocks, kVecThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Backward on `stream`: dlogits.  Returns a cudaError_t.
int repro_traj_logprob_bwd(const TrajLogprobArgs* args, void* stream) {
  const TrajLogprobArgs& a = *args;
  const int err = check(a);
  if (err != 0) return err;
  if (a.batch == 0 || a.steps == 0) return 0;
  const long long blocks = (long long)a.batch * a.steps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = a.num_actions % kUnit == 0;  // the kernel checks alignment
  traj_logprob_bwd_kernel<<<(unsigned)blocks,
                            vec ? kVecThreads : threads_for(a.num_actions),
                            0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
