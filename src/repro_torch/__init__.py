"""PyTorch port of ``repro`` for NVIDIA Hopper GPUs.

The package mirrors ``repro``'s layout (``core/``, ``nn/``, ``envs/``,
``rewards/``, ``kernels/``, ``serve/``, ``launch/``, ``recipes/``) so each
module's counterpart sits at the same path.  It imports torch and numpy
only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``cpu`` they raise
(:func:`repro_torch.device.resolve_device`).

Ported so far: the bitseq serving path — env, reward, decode-arch
transformer policy, cached forward rollout, continuously batched sampling
engine and scheduler — with the fused decode step as a hand-written CUDA
kernel (``kernels/csrc/decode_step.cu``).
"""
