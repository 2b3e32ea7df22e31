"""Checkpoints in the JAX package's on-disk format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
