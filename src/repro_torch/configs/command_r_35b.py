"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

Port of ``repro.configs.command_r_35b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "command-r-35b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=40, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22528,
        vocab_size=256000, qkv_bias=False, tie_embeddings=True,
        rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=False, tie_embeddings=True, remat="none")
