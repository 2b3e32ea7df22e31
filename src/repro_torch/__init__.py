"""PyTorch port of ``repro`` for NVIDIA Hopper GPUs.

The package mirrors ``repro``'s layout (``core/``, ``nn/``, ``envs/``,
``rewards/``, ``kernels/``, ``algo/``, ``evals/``, ``metrics/``,
``serve/``, ``launch/``, ``recipes/``, ``models/``, ``configs/``,
``run.py``) so each module's
counterpart sits at the same path.  It imports torch and numpy only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``cpu`` they raise
(:func:`repro_torch.device.resolve_device`).

Ported so far: the bitseq serving path — env, reward, decode-arch
transformer policy, cached forward rollout, continuously batched sampling
engine and scheduler — with the fused decode step as a hand-written CUDA
kernel (``kernels/csrc/decode_step.cu``); and ``bitseq_tb`` training —
exploring rollout, TB objective, Adam, ``algo.TrainLoop`` and the
``repro_torch.run`` CLI — with the cached attention and the trajectory
log-probabilities (forward and gradient) as hand-written CUDA kernels
(``kernels/csrc/decode_attention.cu``, ``kernels/csrc/traj_logprob.cu``);
and the hypergrid recipes (TB, DB, SubTB) — hypergrid env and reward, MLP
policy, uncached and backward rollouts, the stop-action objectives and the
exact-DP, sampled and log Z bound evals (``evals/``) — with the SubTB loss
and its gradient as a hand-written CUDA kernel pair
(``kernels/csrc/subtb_loss.cu``); and the LM tier's serving path for
Hymba-1.5B (``models/``, ``configs/``, ``launch/lm_decode.py``,
``launch/steps.py``: token-by-token decode with the window cache and the
SSM state, and prompt scoring) with flash attention and the RWKV6 / SSM
scan as hand-written CUDA kernels (``kernels/csrc/flash_attention.cu`` and
``flash_attention_wgmma.cu``; ``kernels/csrc/rwkv6_scan.cu``, the step
recurrence, and ``rwkv6_chunk.cu``, chunk-parallel on the tensor cores).
"""
