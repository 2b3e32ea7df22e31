"""Data pipelines of the port (``tokens``: the LM tier's synthetic
batches)."""
