"""Hand-written GPU kernels, their plain PyTorch versions and wrappers."""
