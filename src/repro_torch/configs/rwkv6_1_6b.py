"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch: data-dependent decay linear attention. [arXiv:2404.05892; unverified]

Port of ``repro.configs.rwkv6_1_6b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="rwkv", num_layers=24, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=7168,
        vocab_size=65536, rwkv_head_size=64, rope_type="none")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="rwkv", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        rwkv_head_size=16, rope_type="none", remat="none")
