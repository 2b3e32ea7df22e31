"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads. [arXiv:2411.13676; hf]

Port of ``repro.configs.hymba_1_5b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", num_layers=32, d_model=1600,
        num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504,
        vocab_size=32001, ssm_state=16, sliding_window=2048,
        rope_theta=1e4)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        ssm_state=4, sliding_window=8, remat="none")
