"""The port on a CUDA GPU: the hand-written decode-step kernel against its
plain PyTorch version, and the serving engine on the card against
``forward_rollout``.  Imports no JAX, so it runs on a machine with a GPU
and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Every test skips on a machine without a GPU (decided in the fixture).
Tolerance 1e-4: fp32 on both sides, in different reduction orders.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_decode_step  # noqa: E402
from repro_torch.serve import SamplingEngine  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _step_inputs(B, L, C, D, H, F, A, seed, device):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, scale=1.0: (scale * torch.randn(s, generator=g)).to(device)
    w = {"ln1_scale": 1 + rn(L, D, scale=0.1), "ln1_bias": rn(L, D, scale=0.1),
         "q_w": rn(L, D, D, scale=D ** -0.5), "q_b": rn(L, D, scale=0.1),
         "kv_w": rn(L, D, 2 * D, scale=D ** -0.5),
         "kv_b": rn(L, 2 * D, scale=0.1),
         "proj_w": rn(L, D, D, scale=D ** -0.5), "proj_b": rn(L, D, scale=0.1),
         "ln2_scale": 1 + rn(L, D, scale=0.1),
         "ln2_bias": rn(L, D, scale=0.1),
         "ff1_w": rn(L, D, F, scale=D ** -0.5), "ff1_b": rn(L, F, scale=0.1),
         "ff2_w": rn(L, F, D, scale=F ** -0.5), "ff2_b": rn(L, D, scale=0.1),
         "ln_f_scale": 1 + rn(D, scale=0.1), "ln_f_bias": rn(D, scale=0.1),
         "q0": rn(D, scale=0.5)}
    lengths = torch.randint(0, C - 1, (B,), generator=g, dtype=torch.int32)
    u = torch.rand((B, A), generator=g).clamp_(1e-12, 1 - 1e-7)
    mask = torch.rand((B, A), generator=g) < 0.5
    mask[:, 0] |= ~mask.any(-1)
    return (w, rn(B, D, scale=0.5), rn(L, B, C, H, D // H),
            rn(L, B, C, H, D // H), lengths.to(device),
            lengths.clamp(1, C - 1).to(device),
            (-torch.log(-torch.log(u))).to(device), mask.to(device),
            rn(D, A, scale=D ** -0.5), rn(A, scale=0.1),
            (0.5 + torch.rand(B, generator=g)).to(device))


@pytest.mark.parametrize("shape", [(64, 3, 16, 64, 8, 256, 3840),
                                   (5, 2, 9, 48, 6, 80, 203),
                                   (1, 1, 7, 16, 2, 40, 33)])
def test_kernel_matches_plain_version(cuda, shape):
    B, L, C, D, H, F, A = shape
    w, x, k, v, lengths, slot, gumbel, mask, w_out, b_out, temp = \
        _step_inputs(*shape, seed=B, device=cuda)
    ref = ref_decode_step(w, x, k.view(L, B, C, D), v.view(L, B, C, D),
                          lengths, slot, gumbel, mask, w_out, b_out, temp,
                          num_heads=H)
    cache = {"k": k.clone(), "v": v.clone()}
    before = ops.decode_step.launches
    a, lp, y, cache = ops.decode_step(w, x, cache, lengths, slot, gumbel,
                                      mask, w_out, b_out, temp, num_heads=H)
    torch.cuda.synchronize()
    assert ops.decode_step.launches == before + 1
    assert torch.equal(a, ref[0])
    for got, want in ((lp, ref[1]), (y, ref[2]),
                      (cache["k"].view(L, B, C, D), ref[3]),
                      (cache["v"].view(L, B, C, D), ref[4])):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kernel_rejects_operands_on_another_device(cuda):
    w, x, k, v, lengths, slot, gumbel, mask, w_out, b_out, temp = \
        _step_inputs(2, 1, 7, 16, 2, 40, 33, seed=0, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.decode_step(w, x, {"k": k, "v": v}, lengths, slot, gumbel.cpu(),
                        mask, w_out, b_out, temp, num_heads=2)


def test_engine_on_cuda_matches_forward_rollout(cuda):
    recipe = recipes.get("bitseq")
    env = recipe.make_env(n=16, k=4)
    params = env.init(cuda)
    policy = recipe.make_policy(env, device=cuda)
    eng = SamplingEngine(env, params, policy, num_lanes=3)
    before = ops.decode_step.launches
    rid = eng.submit(num_samples=7, seed=4, logit_temp=0.9)
    res = eng.run()[rid]
    assert ops.decode_step.launches > before
    ref = forward_rollout(4, env, params, policy, 7, logit_temp=0.9)
    assert (res.samples == ref.obs[-1].cpu().numpy()).all()
