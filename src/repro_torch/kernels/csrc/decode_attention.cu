// Single-query decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:98, pl.pallas_call at :128).
// Computes exactly what `ref_decode_attention` (kernels/ref.py) computes, in
// fp32: for each (b, h), the query q[b, h] (hd floats) attends the cache
// slots s < kv_valid[b] of k[b, :, h], v[b, :, h] with scores q.k / sqrt(hd)
// and a softmax over the live slots.  Rows with kv_valid[b] <= 0 are written
// as exact zeros (an empty attention sum), never as a uniform average.
//
// Design.  One warp per (b, h), four warps per block.  The lanes walk the
// cache 32 slots at a time: lane i scores slot base + i, the warp takes the
// chunk's max, and an online softmax keeps one warp-wide running max m; each
// lane keeps its own partial denominator l and output accumulator acc[hd]
// (registers, hd <= 64), rescaled by exp(m_old - m_new) when m grows.  At the
// end the partial sums are reduced across the warp by shuffles.  So any S
// works (S < 8, S not a multiple of 32, S > 32), with no shared memory and no
// padding of the cache.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32).  The
// training rollout calls it once per layer per step with q (16, 8, 8) and a
// (16, 16, 8, 8) cache of which lengths + 1 slots are live: at most 66 KB of
// K/V, 8 KB of q/out, about 0.1 MFLOP, i.e. about 20 ns at the memory rate.
// The kernel's time is its launch and one warp's serial walk over at most
// 16 slots (one chunk); packing several (b, h) rows per warp is later work.
#include <cuda_runtime.h>

#include <cmath>

// Kernel operands; mirrored field for field by `DecodeAttentionArgs` in
// build.py.  All tensors fp32 except kv_valid, contiguous.
struct DecodeAttentionArgs {
  const float* q;         // (B, H, hd)
  const float* k;         // (B, S, H, hd)
  const float* v;         // (B, S, H, hd)
  const int* kv_valid;    // (B,) live leading slots
  float* out;             // (B, H, hd)
  int batch, slots, num_heads, head_dim, device;
};

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// HD_MAX bounds the head dim at compile time so the per-lane accumulators
// stay in registers; `hd` is the runtime head dim (hd <= HD_MAX).
template <int HD_MAX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    decode_attention_kernel(const DecodeAttentionArgs a) {
  const int B = a.batch, S = a.slots, H = a.num_heads, hd = a.head_dim;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B * H) return;  // whole warps leave together
  const int b = warp / H, h = warp % H;
  const int nv = min(max(a.kv_valid[b], 0), S);

  const float* qr = a.q + ((size_t)b * H + h) * hd;
  float qv[HD_MAX];
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d) qv[d] = d < hd ? __ldg(qr + d) : 0.f;

  const size_t slot_stride = (size_t)H * hd;
  const float* kb = a.k + (size_t)b * S * slot_stride + (size_t)h * hd;
  const float* vb = a.v + (size_t)b * S * slot_stride + (size_t)h * hd;
  const float sqrt_hd = sqrtf((float)hd);

  float m = -INFINITY;  // warp-wide running max
  float l = 0.f;        // this lane's partial denominator
  float acc[HD_MAX];
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d) acc[d] = 0.f;

  for (int base = 0; base < nv; base += 32) {
    const int s = base + lane;
    const bool live = s < nv;
    float sc = -INFINITY;
    if (live) {
      const float* kr = kb + (size_t)s * slot_stride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD_MAX; ++d)
        if (d < hd) dot = fmaf(qv[d], __ldg(kr + d), dot);
      sc = dot / sqrt_hd;
    }
    // lane 0's slot (base < nv) is live, so the chunk max is finite
    const float m_new = fmaxf(m, warp_max(sc));
    const float corr = expf(m - m_new);  // 0 on the first chunk
    const float p = live ? expf(sc - m_new) : 0.f;
    l = l * corr + p;
    const float* vr = vb + (size_t)(live ? s : 0) * slot_stride;
#pragma unroll
    for (int d = 0; d < HD_MAX; ++d)
      if (d < hd) acc[d] = acc[d] * corr + (live ? p * __ldg(vr + d) : 0.f);
    m = m_new;
  }

  l = warp_sum(l);
  float* orow = a.out + ((size_t)b * H + h) * hd;
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d) {
    if (d >= hd) break;
    const float tot = warp_sum(acc[d]);
    if (lane == (d & 31)) orow[d] = nv > 0 ? tot / l : 0.f;
  }
}

template <int HD_MAX>
int launch(const DecodeAttentionArgs& a, cudaStream_t stream) {
  const int rows = a.batch * a.num_heads;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_attention_kernel<HD_MAX><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one decode-attention pass on `stream`; returns a cudaError_t
// (0 = success).  Head dims above 64 are refused (cudaErrorInvalidValue).
int repro_decode_attention(const DecodeAttentionArgs* args, void* stream) {
  const DecodeAttentionArgs& a = *args;
  if (a.batch < 0 || a.slots < 0 || a.num_heads < 1 || a.head_dim < 1 ||
      a.head_dim > 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim <= 8) return launch<8>(a, s);
  if (a.head_dim <= 16) return launch<16>(a, s);
  if (a.head_dim <= 32) return launch<32>(a, s);
  return launch<64>(a, s);
}

}  // extern "C"
