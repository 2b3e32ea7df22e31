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
// Design.  One block per (b, t) row.  Each thread folds its strided share of
// the row into an online (max, sum of exp) pair, so the forward reads the
// row once; pairs combine across the warp by shuffles and across warps in
// shared memory.  The forward writes per_step; a second, tiny kernel sums
// per_step over t for each b in a fixed order (no float atomics, so two runs
// agree bit for bit).  The backward re-derives the pair and writes the
// gradient row in a second sweep over the row.  Logits, mask, actions and
// valid are read through their (B, T) strides with a unit stride along A,
// so the transposed time-major views of the training path need no copy.
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
  long long logits_sb, logits_st, mask_sb, mask_st, actions_sb, actions_st;
  long long valid_sb, valid_st, g_step_sb, g_step_st;
  int batch, steps, num_actions, device;
};

namespace {

constexpr int kMaxWarps = 8;

// Fold v into the online pair (m, s): s = sum exp(x - m) over folded x.
__device__ __forceinline__ void online_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;  // m = -inf at first: s = 0 * 0 + 1
    m = v;
  } else {
    s += expf(v - m);
  }
}

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

// Block-wide (max, sum of exp) of the row; every thread gets the result.
__device__ void block_pair(float& m, float& s) {
  __shared__ float sm[kMaxWarps], ss[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    online_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
                 __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
  for (int w = 0; w < nwarps; ++w) online_merge(m, s, sm[w], ss[w]);
}

__device__ __forceinline__ float masked_at(const float* x, const uint8_t* mk,
                                           int j) {
  return mk[j] ? x[j] : -FLT_MAX;
}

__global__ void traj_logprob_fwd_rows(const TrajLogprobArgs a) {
  const int T = a.steps, A = a.num_actions;
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  const float* x = a.logits + b * a.logits_sb + t * a.logits_st;
  const uint8_t* mk = a.mask + b * a.mask_sb + t * a.mask_st;
  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    online_add(m, s, masked_at(x, mk, j));
  block_pair(m, s);
  if (threadIdx.x == 0) {
    const bool live = a.valid[b * a.valid_sb + t * a.valid_st] != 0;
    const int64_t act = a.actions[b * a.actions_sb + t * a.actions_st];
    float lpa = 0.f;  // an action outside [0, A) matches no column
    if (live && act >= 0 && act < A)
      lpa = masked_at(x, mk, (int)act) - (m + logf(s));
    a.per_step[(size_t)b * T + t] = lpa;
  }
}

// total[b] = sum_t per_step[b, t], in order of t.
__global__ void traj_logprob_totals(const TrajLogprobArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.batch) return;
  const float* row = a.per_step + (size_t)b * a.steps;
  float acc = 0.f;
  for (int t = 0; t < a.steps; ++t) acc += row[t];
  a.total[b] = acc;
}

__global__ void traj_logprob_bwd_rows(const TrajLogprobArgs a) {
  const int T = a.steps, A = a.num_actions;
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  const float* x = a.logits + b * a.logits_sb + t * a.logits_st;
  const uint8_t* mk = a.mask + b * a.mask_sb + t * a.mask_st;
  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    online_add(m, s, masked_at(x, mk, j));
  block_pair(m, s);
  const bool live = a.valid[b * a.valid_sb + t * a.valid_st] != 0;
  const float coeff =
      (a.g_total[b] + a.g_step[b * a.g_step_sb + t * a.g_step_st]) *
      (live ? 1.f : 0.f);
  const int64_t act = a.actions[b * a.actions_sb + t * a.actions_st];
  float* out = a.dlogits + ((size_t)b * T + t) * A;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    const float p = expf(masked_at(x, mk, j) - m) / s;  // softmax
    out[j] = coeff * ((j == act ? 1.f : 0.f) - p);
  }
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

// Forward on `stream`: per_step, then total.  Returns a cudaError_t.
int repro_traj_logprob_fwd(const TrajLogprobArgs* args, void* stream) {
  const TrajLogprobArgs& a = *args;
  int err = check(a);
  if (err != 0) return err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.steps > 0) {
    traj_logprob_fwd_rows<<<a.batch * a.steps, threads_for(a.num_actions), 0,
                            s>>>(a);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  traj_logprob_totals<<<(a.batch + 127) / 128, 128, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Backward on `stream`: dlogits.  Returns a cudaError_t.
int repro_traj_logprob_bwd(const TrajLogprobArgs* args, void* stream) {
  const TrajLogprobArgs& a = *args;
  const int err = check(a);
  if (err != 0) return err;
  if (a.batch == 0 || a.steps == 0) return 0;
  traj_logprob_bwd_rows<<<a.batch * a.steps, threads_for(a.num_actions), 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
