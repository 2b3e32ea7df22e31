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
// What bounds it.  The training rollout calls it once per layer per step
// with q (16, 8, 8) and a (16, 16, 8, 8) cache of which kv_valid slots are
// live: at most 66 KB of K/V and 8 KB of q and out, about 0.1 MFLOP, 0.023
// us at 3.35 TB/s (H100 SXM data sheet).  So the floor is the launch
// itself: chip_smoke.py measures it in the same run (`floor_us`, the device
// time of a one-element in-place add).
//
// Design.  One block per batch row b takes all H heads (128 threads; 256
// for hd > 16, 512 for hd > 32).  A head's hd floats go to hd/4 threads of 4
// floats each (a "head group"; hd = 8: 2 threads), so a slot's H * hd
// floats are read with 16-byte loads by neighbouring threads.  The head
// groups left over after one per head take further "phases": phase p of a
// head walks slots p, p + nph, ... (nph = 8 at hd = 8, H = 8).  A thread
// issues the K and V loads of all its slots of a chunk (kChunk = 4 slots:
// 32 slots at the training shape, so S <= 32 is one pass) before any
// reduction, sums its 4 products, and a head group adds its partial dots
// by xor shuffles (1 step at hd = 8).  Each phase keeps its own running
// max, denominator and 4 outputs (an online softmax across chunks, for
// S > nph * kChunk); at the end the phases merge in phase order through
// shared memory.  Head dims up to 64 (16 threads a head); with more heads
// than groups a group takes several heads in turn.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py): 2.95 us at
// (16, 16, 8, 8), against a launch floor of 1.15 us in the same run (the
// previous design, a warp per (b, h) with scalar loads: 3.87 us).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

constexpr int kChunk = 4;  // slots a thread loads before it reduces
constexpr unsigned kFull = 0xffffffffu;

// Four head elements d0..d0+3 of the row at p (zeros past hd); 16-byte
// loads when `vec` (hd % 4 == 0 and every operand 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p, int d0, int hd,
                                        bool vec) {
  if (d0 >= hd) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + d0));
  return make_float4(__ldg(p + d0), d0 + 1 < hd ? __ldg(p + d0 + 1) : 0.f,
                     d0 + 2 < hd ? __ldg(p + d0 + 2) : 0.f,
                     d0 + 3 < hd ? __ldg(p + d0 + 3) : 0.f);
}

// TPH: threads per head (hd <= 4 * TPH), a power of two <= 16.  A block
// has at least 32 head groups (128 threads, more for wide heads).
template <int TPH>
__host__ __device__ constexpr int block_threads() {
  return 32 * TPH > 128 ? 32 * TPH : 128;
}

template <int TPH>
__global__ void __launch_bounds__(block_threads<TPH>())
    decode_attention_kernel(const DecodeAttentionArgs a, bool vec) {
  constexpr int kThreads = block_threads<TPH>();
  constexpr int kGroups = kThreads / TPH;  // head groups of the block
  const int S = a.slots, H = a.num_heads, hd = a.head_dim;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int u = tid / TPH, gi = tid % TPH, d0 = 4 * gi;
  const int nv = min(max(a.kv_valid[b], 0), S);
  // phases per head, and passes over the heads when there are more heads
  // than groups
  const int nph = H >= kGroups ? 1 : kGroups / H;
  const int passes = H >= kGroups ? (H + kGroups - 1) / kGroups : 1;
  const size_t slot_stride = (size_t)H * hd;
  const float sqrt_hd = sqrtf((float)hd);

  __shared__ float part_m[kGroups], part_l[kGroups];
  __shared__ float4 part_o[kThreads];

  for (int pass = 0; pass < passes; ++pass) {
    const int hh = nph == 1 ? pass * kGroups + u : u % H;
    const int ph = nph == 1 ? 0 : u / H;
    const bool on = hh < H && ph < nph;
    const int hs = on ? hh : 0;
    const float4 qv = on ? load4(a.q + ((size_t)b * H + hs) * hd, d0, hd, vec)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* kb = a.k + (size_t)b * S * slot_stride + (size_t)hs * hd;
    const float* vb = a.v + (size_t)b * S * slot_stride + (size_t)hs * hd;

    float m = -INFINITY, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < nv; base += kChunk * nph) {
      float4 kr[kChunk], vr[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = base + ph + j * nph;
        const bool live = on && s < nv;
        kr[j] = live ? load4(kb + s * slot_stride, d0, hd, vec)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        vr[j] = live ? load4(vb + s * slot_stride, d0, hd, vec)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float sc[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = qv.x * kr[j].x;
        dot = fmaf(qv.y, kr[j].y, dot);
        dot = fmaf(qv.z, kr[j].z, dot);
        dot = fmaf(qv.w, kr[j].w, dot);
#pragma unroll
        for (int o = TPH / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        const bool live = on && base + ph + j * nph < nv;
        sc[j] = live ? dot / sqrt_hd : -INFINITY;
        cmax = fmaxf(cmax, sc[j]);
      }
      if (cmax == -INFINITY) continue;  // none of this phase's slots live
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);  // 0 on the phase's first chunk
      l *= corr;
      acc.x *= corr;
      acc.y *= corr;
      acc.z *= corr;
      acc.w *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(sc[j] - m_new);  // 0 for a dead slot
        l += p;
        acc.x = fmaf(p, vr[j].x, acc.x);
        acc.y = fmaf(p, vr[j].y, acc.y);
        acc.z = fmaf(p, vr[j].z, acc.z);
        acc.w = fmaf(p, vr[j].w, acc.w);
      }
      m = m_new;
    }

    if (nph > 1) {  // merge the phases of each head, in phase order
      if (gi == 0) {
        part_m[u] = m;
        part_l[u] = l;
      }
      part_o[tid] = acc;
      __syncthreads();
      if (!on || ph != 0) continue;
      float mm = -INFINITY;
      for (int k = 0; k < nph; ++k) mm = fmaxf(mm, part_m[u + k * H]);
      l = 0.f;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < nph; ++k) {
        const int uk = u + k * H;
        const float f = part_m[uk] == -INFINITY ? 0.f : expf(part_m[uk] - mm);
        const float4 ok = part_o[uk * TPH + gi];
        l = fmaf(part_l[uk], f, l);
        acc.x = fmaf(ok.x, f, acc.x);
        acc.y = fmaf(ok.y, f, acc.y);
        acc.z = fmaf(ok.z, f, acc.z);
        acc.w = fmaf(ok.w, f, acc.w);
      }
    }
    if (!on || d0 >= hd) continue;
    float* orow = a.out + ((size_t)b * H + hh) * hd;
    const float4 res = nv > 0 ? make_float4(acc.x / l, acc.y / l, acc.z / l,
                                            acc.w / l)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) {
      *reinterpret_cast<float4*>(orow + d0) = res;
    } else {
      orow[d0] = res.x;
      if (d0 + 1 < hd) orow[d0 + 1] = res.y;
      if (d0 + 2 < hd) orow[d0 + 2] = res.z;
      if (d0 + 3 < hd) orow[d0 + 3] = res.w;
    }
  }
}

template <int TPH>
int launch(const DecodeAttentionArgs& a, bool vec, cudaStream_t stream) {
  decode_attention_kernel<TPH>
      <<<a.batch, block_threads<TPH>(), 0, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  const bool vec = a.head_dim % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim <= 4) return launch<1>(a, vec, s);
  if (a.head_dim <= 8) return launch<2>(a, vec, s);
  if (a.head_dim <= 16) return launch<4>(a, vec, s);
  if (a.head_dim <= 32) return launch<8>(a, vec, s);
  return launch<16>(a, vec, s);
}

}  // extern "C"
