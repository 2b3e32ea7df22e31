"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01;
unverified]

Port of ``repro.configs.command_r_plus_104b``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "command-r-plus-104b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=64, d_model=12288,
        num_heads=96, num_kv_heads=8, head_dim=128, d_ff=33792,
        vocab_size=256000, qkv_bias=False, tie_embeddings=True,
        rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=96,
        num_heads=6, num_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
        qkv_bias=False, tie_embeddings=True, remat="none")
