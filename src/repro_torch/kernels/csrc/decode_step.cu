// Fused decode step of the latent-query policy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_step_pallas`
// (src/repro/kernels/decode_attention.py:239, pl.pallas_call at :274).
// Computes exactly what `ref_decode_step` (kernels/ref.py) computes, in
// fp32, for each lane b of the batch:
//   1. append: K/V projections of the new token x_new[b] for every layer
//      land in the caller's cache at slot[b];
//   2. decode: the latent query q0 runs through L pre-LN layers (LN -> q ->
//      per-head attention over slots 0..lengths[b] -> proj -> LN ->
//      tanh-GELU MLP), then the final LN gives y;
//   3. sample: readout logits * logit_temp, masked to -FLT_MAX,
//      log-softmax, Gumbel-max action (ties to the lowest index), log_pf.
//
// Design.  One block of 256 threads per lane (grid = B).  The running state
// h, the LN output, q, the attention output, the MLP activation, the
// attention scores and the lane's A logits live in shared memory (about
// 18 KB at the serving shape).  Weights are read straight from global
// memory; the whole stack (about 400K floats, 1.6 MB) stays in the 50 MB L2
// across blocks.  Each GEMV gives one output column per thread, so the
// threads of a warp read neighbouring columns of a row-major (in, out)
// weight: the readout thread a reads column a of w_out (D, A), coalesced.
// Reductions (LN mean and variance, log-softmax max and sum, Gumbel argmax)
// are warp shuffles plus one shared-memory pass.
//
// Append in place.  The Pallas kernel copies the whole cache to a new
// output (`kco_ref[...] = kc_ref[...]`, decode_attention.py:177-178).  This
// kernel writes only the new token's L x 2D floats into the caller's cache,
// which is why cache reads here bypass the read-only (__ldg) path: a block
// reads back, after __syncthreads, the slot it has just written.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  Per
// lane at the serving shape (L=3, D=64, H=8, C=16, F=256, A=3840): about
// 45 KB of traffic (cache 24.6 KB, Gumbel 15.4 KB, mask 3.8 KB, append
// 1.5 KB) and about 0.79 MFLOP, plus 1.6 MB of weights once.  At 256 lanes
// that is about 13 MB / 3.35 TB/s = 4 us, near launch latency, so the card
// is far from its rates and the kernel's time is its serial latency: a
// block walks 3 layers of small GEMVs and block-wide reductions one after
// another.  This simple design accepts that; several lanes per block,
// split-K GEMVs and tensor cores are later work.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread of the block gets the result.  The
// leading barrier keeps `red` from being overwritten while a previous
// reduction is still reading it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < kWarps ? red[lane] : -FLT_MAX);
}

// (value, index) argmax; ties resolve to the lowest index, as jnp.argmax.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ int block_argmax(float v, int i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
               __shfl_xor_sync(0xffffffffu, i, o));
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  v = lane < kWarps ? redv[lane] : -INFINITY;
  i = lane < kWarps ? redi[lane] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
               __shfl_xor_sync(0xffffffffu, i, o));
  return i;
}

// out = LN(in) * scale + bias over n elements, population variance.
__device__ void layernorm(const float* in, float* out, const float* scale,
                          const float* bias, int n, float* red) {
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) s += in[j];
  const float mu = block_sum(s, red) / n;
  float s2 = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float d = in[j] - mu;
    s2 += d * d;
  }
  const float var = block_sum(s2, red) / n;
  const float r = 1.f / sqrtf(var + 1e-5f);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    out[j] = (in[j] - mu) * r * scale[j] + bias[j];
  __syncthreads();
}

// out[j] = (res[j] + sum_i in[i] * W[i, j]) + b[j] for a row-major (K, N) W;
// `res` may be null.  One output column per thread.
__device__ void gemv(const float* in, const float* __restrict__ W,
                     const float* __restrict__ b, const float* res,
                     float* out, int K, int N) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < K; ++i)
      acc = fmaf(in[i], __ldg(W + (size_t)i * N + j), acc);
    out[j] = (res ? res[j] + acc : acc) + __ldg(b + j);
  }
  __syncthreads();
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__global__ void __launch_bounds__(kThreads)
    decode_step_kernel(const DecodeStepArgs a) {
  const int L = a.num_layers, B = a.batch, C = a.capacity, D = a.dim;
  const int H = a.num_heads, F = a.ff_dim, A = a.num_actions;
  const int hd = D / H;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* xs = smem;             // (D) new token embedding
  float* h = xs + D;            // (D) latent query state
  float* g = h + D;             // (D) LN output
  float* q = g + D;             // (D) query
  float* o = q + D;             // (D) attention output
  float* ff = o + D;            // (F) MLP activation
  float* sc = ff + F;           // (H, C) attention scores
  float* lg = sc + H * C;       // (A) masked logits
  float* red = lg + A;          // (32) reduction scratch
  int* redi = reinterpret_cast<int*>(red + 32);  // (32)

  for (int j = tid; j < D; j += blockDim.x) {
    xs[j] = a.x_new[(size_t)b * D + j];
    h[j] = a.q0[j];
  }
  __syncthreads();

  // 1. append every layer's K/V of the new token at slot[b]
  const int s = a.slot[b];
  if (s >= 0 && s < C) {
    for (int l = 0; l < L; ++l) {
      const float* W = a.kv_w + (size_t)l * D * 2 * D;
      for (int e = tid; e < 2 * D; e += blockDim.x) {
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; ++i)
          acc = fmaf(xs[i], __ldg(W + (size_t)i * 2 * D + e), acc);
        acc += __ldg(a.kv_b + (size_t)l * 2 * D + e);
        float* dst = e < D ? a.k_cache : a.v_cache;
        dst[(((size_t)l * B + b) * C + s) * D + (e < D ? e : e - D)] = acc;
      }
    }
  }
  __syncthreads();

  // 2. latent query through the layer stack
  const int nv = min(a.lengths[b] + 1, C);  // BOS + tokens
  const float sqrt_hd = sqrtf((float)hd);
  for (int l = 0; l < L; ++l) {
    const float* kl = a.k_cache + ((size_t)l * B + b) * C * D;
    const float* vl = a.v_cache + ((size_t)l * B + b) * C * D;
    layernorm(h, g, a.ln1_scale + l * D, a.ln1_bias + l * D, D, red);
    gemv(g, a.q_w + (size_t)l * D * D, a.q_b + l * D, nullptr, q, D, D);
    for (int idx = tid; idx < H * nv; idx += blockDim.x) {
      const int hh = idx / nv, c = idx % nv;
      float acc = 0.f;
      for (int i = 0; i < hd; ++i)
        acc = fmaf(q[hh * hd + i], kl[(size_t)c * D + hh * hd + i], acc);
      sc[hh * C + c] = acc / sqrt_hd;
    }
    __syncthreads();
    for (int j = tid; j < D; j += blockDim.x) {
      const float* srow = sc + (j / hd) * C;
      float m = -FLT_MAX;
      for (int c = 0; c < nv; ++c) m = fmaxf(m, srow[c]);
      float den = 0.f, acc = 0.f;
      for (int c = 0; c < nv; ++c) {
        const float p = expf(srow[c] - m);
        den += p;
        acc = fmaf(p, vl[(size_t)c * D + j], acc);
      }
      o[j] = acc / fmaxf(den, 1e-30f);
    }
    __syncthreads();
    gemv(o, a.proj_w + (size_t)l * D * D, a.proj_b + l * D, h, h, D, D);
    layernorm(h, g, a.ln2_scale + l * D, a.ln2_bias + l * D, D, red);
    gemv(g, a.ff1_w + (size_t)l * D * F, a.ff1_b + l * F, nullptr, ff, D, F);
    for (int j = tid; j < F; j += blockDim.x) ff[j] = gelu_tanh(ff[j]);
    __syncthreads();
    gemv(ff, a.ff2_w + (size_t)l * F * D, a.ff2_b + l * D, h, h, F, D);
  }
  layernorm(h, g, a.lnf_scale, a.lnf_bias, D, red);
  for (int j = tid; j < D; j += blockDim.x) a.y[(size_t)b * D + j] = g[j];

  // 3. readout, masked log-softmax, Gumbel-max sample
  const float temp = a.logit_temp ? a.logit_temp[b] : 1.f;
  const uint8_t* mrow = a.mask + (size_t)b * A;
  float lmax = -FLT_MAX;
  for (int j = tid; j < A; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < D; ++i)
      acc = fmaf(g[i], __ldg(a.w_out + (size_t)i * A + j), acc);
    const float logit = (acc + __ldg(a.b_out + j)) * temp;
    const float ml = mrow[j] ? logit : -FLT_MAX;
    lg[j] = ml;
    lmax = fmaxf(lmax, ml);
  }
  const float m = block_max(lmax, red);
  float se = 0.f;
  for (int j = tid; j < A; j += blockDim.x) se += expf(lg[j] - m);
  const float lse = m + logf(block_sum(se, red));
  const float* grow = a.gumbel + (size_t)b * A;
  float best = -INFINITY;
  int besti = INT_MAX;
  for (int j = tid; j < A; j += blockDim.x)
    arg_better(best, besti, (lg[j] - lse) + grow[j], j);
  const int act = block_argmax(best, besti, red, redi);
  if (tid == 0) {
    a.action[b] = act;
    a.log_pf[b] = lg[act] - lse;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for one lane.
size_t repro_decode_step_smem_bytes(int dim, int ff_dim, int num_heads,
                                    int capacity, int num_actions) {
  return sizeof(float) * ((size_t)5 * dim + ff_dim +
                          (size_t)num_heads * capacity + num_actions + 64);
}

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
  const size_t smem = repro_decode_step_smem_bytes(
      a.dim, a.ff_dim, a.num_heads, a.capacity, a.num_actions);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_step_kernel<<<a.batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
