"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 60 experts are padded to 64 (a multiple of 16; the pad experts' router
logits are -inf, so they take no token).

Port of ``repro.configs.qwen2_moe_a2_7b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=5632,
        vocab_size=151936, num_experts=60, num_experts_per_tok=4,
        num_shared_experts=4, moe_d_ff=1408, shared_d_ff=5632,
        qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        num_experts=6, num_experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=32, shared_d_ff=64, qkv_bias=True, remat="none")
