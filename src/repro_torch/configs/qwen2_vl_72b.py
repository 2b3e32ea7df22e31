"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only: the vision frontend is a stub, as in the reference -- the
caller hands in patch embeddings (B, S, d_model) and 3-component (t, h, w)
M-RoPE position ids (3, B, S).

Port of ``repro.configs.qwen2_vl_72b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
        vocab_size=152064, qkv_bias=True, rope_type="mrope",
        mrope_sections=(16, 24, 24), rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=True, rope_type="mrope", mrope_sections=(2, 3, 3),
        remat="none")
