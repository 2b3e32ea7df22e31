"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Port of ``repro.configs.qwen3_moe_30b_a3b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
        vocab_size=151936, num_experts=128, num_experts_per_tok=8,
        num_shared_experts=0, moe_d_ff=768, shared_d_ff=0,
        qkv_bias=False, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        num_experts=8, num_experts_per_tok=2, num_shared_experts=0,
        moe_d_ff=32, shared_d_ff=0, remat="none")
