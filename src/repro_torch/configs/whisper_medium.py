"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

The modality frontend is a stub, as in the reference: the caller hands in
frame embeddings (batch, frames, d_model) for the encoder.

Port of ``repro.configs.whisper_medium``: the same two configs.
"""
from ..models.config import ModelConfig

ARCH_ID = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=51865, encoder_layers=24, rope_type="none",
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="encdec", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        encoder_layers=2, rope_type="none", tie_embeddings=True, remat="none")
