"""Functional layers and the decode-arch transformer."""
