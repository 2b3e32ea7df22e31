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
// Design.  One block per trajectory.  The Pallas kernel walks (j, k) tiles
// of 128 in order and carries num/den in VMEM scratch; here the block loads
// phi_b[0..n] and the weight table lam^d, d = 0..n (one powf per entry, not
// one exp per pair), into shared memory, then each warp takes rows j in
// turn and its lanes stride over k in (j, n]: no padding, and k never
// passes n < T+1 (n is clamped to [0, T] in the kernel too).  num and den
// reduce in fp32 by warp shuffles plus one shared-memory pass over the
// warps in a fixed order; no float atomics, so two runs agree bit for bit.
// The backward gives each thread a state i (striding past blockDim) and
// sums over m: O(n^2) per trajectory, like the forward.  phi is read
// through its (B, T+1) strides, so the time-major (T+1, B) tensor of the
// loss arrives as a transposed view, not a copy.  Where T+1 exceeds
// kSmemStates the block reads phi from device memory through its strides
// and the table from a scratch buffer that a first, tiny kernel fills.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  At the
// training shape (B = 16, T+1 = 30) the forward reads 1.9 KB of phi and
// 64 B of lengths and writes 64 B: under 1 ns at the memory rate; the
// pairs cost 16 * 435 * 5 = 35 kFLOP, about 0.5 ns.  Either bound is
// three orders below a launch: the kernel is bound by launch latency and
// the serial dependence of its reduction, not by bytes or operations.
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
  float* table;          // (T+1,) scratch, used when T+1 > kSmemStates
  long long phi_sb, phi_st;
  float lam;
  int batch, states, device;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// phi and the table in shared memory: 2 * 6144 * 4 B = 48 KB, the most a
// block takes without opting in to more
constexpr int kSmemStates = 6144;

// Sum of v over the block, returned to every thread.  Warp butterflies
// (every lane ends with the same bits), then the warps' sums in order.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red may be reused
  return s;
}

// The trajectory's potentials and weight table: in shared memory when they
// fit, else straight from device memory.  Returns n, clamped to [0, T].
struct Row {
  const float* phi;
  long long stride;
  const float* table;
  int n;
};

__device__ Row load_row(const SubtbArgs& a, float* smem) {
  const int b = blockIdx.x, T1 = a.states;
  const int n = min(max(a.length[b], 0), T1 - 1);
  const float* row = a.phi + b * a.phi_sb;
  if (T1 > kSmemStates) return Row{row, a.phi_st, a.table, n};
  float* sphi = smem;
  float* stab = smem + T1;
  for (int t = threadIdx.x; t <= n; t += blockDim.x) {
    sphi[t] = row[t * a.phi_st];
    stab[t] = powf(a.lam, (float)t);
  }
  __syncthreads();
  return Row{sphi, 1, stab, n};
}

__global__ void subtb_table(const SubtbArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d < a.states) a.table[d] = powf(a.lam, (float)d);
}

__global__ void subtb_fwd(const SubtbArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const Row r = load_row(a, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float num = 0.f, den = 0.f;
  for (int j = warp; j < r.n; j += kWarps) {
    const float pj = r.phi[j * r.stride];
    for (int k = j + 1 + lane; k <= r.n; k += 32) {
      const float w = r.table[k - j];
      const float d = pj - r.phi[k * r.stride];
      num += w * d * d;
      den += w;
    }
  }
  num = block_sum(num, red);
  den = block_sum(den, red);
  if (threadIdx.x == 0) a.loss[blockIdx.x] = num / fmaxf(den, 1e-9f);
}

__global__ void subtb_bwd(const SubtbArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const Row r = load_row(a, smem);
  // den = sum_{j<k<=n} lam^(k-j) = sum_{d=1..n} (n + 1 - d) lam^d
  float den = 0.f;
  for (int d = 1 + threadIdx.x; d <= r.n; d += blockDim.x)
    den += (float)(r.n + 1 - d) * r.table[d];
  den = block_sum(den, red);
  const float scale = 2.f * a.g[blockIdx.x] / fmaxf(den, 1e-9f);
  float* out = a.dphi + (size_t)blockIdx.x * a.states;
  for (int i = threadIdx.x; i < a.states; i += blockDim.x) {
    float s = 0.f;
    if (i <= r.n) {
      const float pi = r.phi[i * r.stride];
      for (int m = 0; m <= r.n; ++m)
        if (m != i) s += r.table[abs(i - m)] * (pi - r.phi[m * r.stride]);
    }
    out[i] = scale * s;
  }
}

// Checks, the scratch table where phi does not fit in shared memory, and
// the shared-memory size of the main kernel.
int prepare(const SubtbArgs& a, cudaStream_t s, size_t* smem) {
  if (a.batch < 0 || a.states < 1 || !(a.lam > 0.f && a.lam <= 1.f))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(a.device);
  if (err != 0) return err;
  *smem = 0;
  if (a.states > kSmemStates) {
    if (a.table == nullptr) return (int)cudaErrorInvalidValue;
    subtb_table<<<(a.states + 255) / 256, 256, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  *smem = 2 * (size_t)a.states * sizeof(float);
  return 0;
}

}  // namespace

extern "C" {

// Forward on `stream`: loss.  Returns a cudaError_t.
int repro_subtb_fwd(const SubtbArgs* args, void* stream) {
  const SubtbArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  int err = prepare(a, s, &smem);
  if (err != 0 || a.batch == 0) return err;
  subtb_fwd<<<a.batch, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Backward on `stream`: dphi.  Returns a cudaError_t.
int repro_subtb_bwd(const SubtbArgs* args, void* stream) {
  const SubtbArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  int err = prepare(a, s, &smem);
  if (err != 0 || a.batch == 0) return err;
  subtb_bwd<<<a.batch, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The number of states beyond which phi and the table stay in device
// memory (the wrapper allocates the scratch table then).
int repro_subtb_smem_states(void) { return kSmemStates; }

}  // extern "C"
