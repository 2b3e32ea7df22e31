"""Optimizers of the port (``adamw``: the JAX package's transforms)."""
