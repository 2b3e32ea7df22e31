// Operands of the flash-attention backward kernels (flash_attention_bwd.cu,
// the SIMT kernel; flash_attention_bwd_wgmma.cu, the tensor-core kernel);
// mirrored field for field by `FlashAttentionBwdArgs` in build.py.  Every
// tensor contiguous; q, k, v, out, dout, dq, dk, dv of one dtype (bf16 !=
// 0: bf16, else fp32).
#pragma once

struct FlashAttentionBwdArgs {
  const void* q;     // (B, Sq, H, D)
  const void* k;     // (B, Skv, KVH, D)
  const void* v;     // (B, Skv, KVH, D)
  const void* out;   // (B, Sq, H, D), the forward's output
  const void* dout;  // (B, Sq, H, D)
  const float* lse;  // (B, H, Sq), the forward's row log-sum-exp
  float* delta;      // scratch: the SIMT kernel's (B, H, Sq) rowsum(dout *
                     // out); the wgmma kernel's 2 x (B, H, Sq') with Sq'
                     // = Sq rounded up to 64: that rowsum, then lse in
                     // log2 units (+inf past Sq and where lse = -inf)
  void* dq;          // (B, Sq, H, D)
  void* dk;          // (B, Skv, KVH, D)
  void* dv;          // (B, Skv, KVH, D)
  int batch, q_len, kv_size, num_heads, num_kv_heads, head_dim;
  int causal, window, bf16, device;
};
