// Operands of the flash-attention kernels (flash_attention.cu, the SIMT
// kernel; flash_attention_wgmma.cu, the tensor-core kernel); mirrored field
// for field by `FlashAttentionArgs` in build.py.  q, k, v, out contiguous,
// all of one dtype (bf16 != 0: bf16, else fp32).  `lse`, when not null,
// receives each query row's log-sum-exp of its scaled scores (natural log,
// -inf for a row that attends no key): the backward pass
// (flash_attention_bwd.cu) reads it; the serve, scoring and decode paths
// pass null and the kernels then write nothing more.
#pragma once

struct FlashAttentionArgs {
  const void* q;  // (B, Sq, H, D)
  const void* k;  // (B, Skv, KVH, D)
  const void* v;  // (B, Skv, KVH, D)
  void* out;      // (B, Sq, H, D)
  float* lse;     // (B, H, Sq) fp32, or null
  int batch, q_len, kv_size, num_heads, num_kv_heads, head_dim;
  int causal, window, q_offset, kv_len;
  int bf16, device;
};
