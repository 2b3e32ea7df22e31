"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671; hf]

Port of ``repro.configs.qwen2_72b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen2-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
        vocab_size=152064, qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=True, remat="none")
