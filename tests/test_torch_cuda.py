"""The port on a CUDA GPU: the hand-written kernels (decode step, decode
attention, trajectory log-prob forward and backward, SubTB loss forward
and backward, flash attention, the RWKV6 scan on both of its routes)
against their plain PyTorch versions, the serving engine on the card
against ``forward_rollout``, two bitseq_tb training iterations, one
full-size hypergrid_subtb iteration, one iteration of each sequence-design
recipe (tfbind8_tb, qm9_tb, amp_tb) and Hymba's smoke config (scoring and
decode) on the card against the CPU.  Imports no JAX, so it runs on a
machine with a GPU and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Every test skips on a machine without a GPU (decided in the fixture).
Tolerance 1e-4: fp32 on both sides, in different reduction orders.  The
flash and scan kernels' bf16 outputs are held entry by entry to
2^-7 |want| + 1e-3 rms(want): the two sides round the same fp32 value, and
may land one bf16 ulp apart (at most 2^-7 of the entry).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    chunked_linear_attention_ref, ref_decode_attention, ref_decode_step,
    ref_flash_attention, ref_rwkv6, ref_subtb, ref_subtb_backward,
    ref_traj_logprob, ref_traj_logprob_backward)
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
                                   (1, 1, 7, 16, 2, 40, 33),
                                   (256, 2, 9, 64, 8, 256, 4),
                                   (128, 3, 61, 64, 8, 256, 21)])
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


@pytest.mark.parametrize("order", ["reversed", "subset", "repeat"])
def test_kernel_lanes_are_bitwise_independent_of_their_tile(cuda, order):
    """The fused step's lanes run in tiles of a thread-block cluster: a
    lane's action, log_pf, y and appended cache row are bitwise the same
    whatever its neighbours and place, and a repeated call is equal."""
    B, L, C, D, H, F, A = 64, 3, 16, 64, 8, 256, 3840
    w, x, k, v, lengths, slot, gumbel, mask, w_out, b_out, temp = \
        _step_inputs(B, L, C, D, H, F, A, seed=11, device=cuda)

    def run(idx):
        cache = {"k": k[:, idx].clone(), "v": v[:, idx].clone()}
        a, lp, y, cache = ops.decode_step(
            w, x[idx], cache, lengths[idx], slot[idx], gumbel[idx],
            mask[idx], w_out, b_out, temp[idx], num_heads=H)
        return a, lp, y, cache["k"], cache["v"]

    every = torch.arange(B, device=cuda)
    idx = {"reversed": every.flip(0),
           "subset": torch.tensor([3, 17, 40, 41, 63], device=cuda),
           "repeat": every}[order]
    full, part = run(every), run(idx)
    torch.cuda.synchronize()
    for got, want in zip(part[:3], full):
        assert torch.equal(got, want[idx])
    for got, want in zip(part[3:], full[3:]):
        assert torch.equal(got, want[:, idx])


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


# -- decode_attention -----------------------------------------------------------

def _attn_inputs(B, S, H, hd, kv_valid, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g).to(device)
    return (rn(B, H, hd), rn(B, S, H, hd), rn(B, S, H, hd),
            torch.as_tensor(kv_valid, dtype=torch.int32).to(device))


@pytest.mark.parametrize("B,S,H,hd,kv_valid", [
    (16, 16, 8, 8, list(range(1, 17))),          # the training rollout
    (5, 37, 3, 8, [0, 1, 36, 37, 0]),            # odd, with empty rows
    (4, 100, 8, 8, [100, 33, 64, 1]),            # several 32-slot chunks
    (3, 5, 2, 64, [0, 5, 9]),                    # wide heads, S < 8
    (16, 16, 8, 16, list(range(1, 17))),         # every head dim to 64
    (16, 16, 8, 32, list(range(1, 17))),
    (16, 16, 8, 64, list(range(1, 17))),
    (4, 100, 8, 16, [100, 0, 57, 3]),            # and at S = 100
    (4, 100, 8, 32, [100, 0, 57, 3]),
    (4, 100, 8, 64, [100, 0, 57, 3]),
    (3, 9, 5, 6, [9, 4, 0]),                     # hd not a multiple of 4
    (16, 9, 8, 8, [1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9, 5, 5, 1, 3]),
    (16, 61, 8, 8, [1, 2, 6, 11, 61, 60, 33, 7, 61, 2, 45, 19, 61, 30, 3,
                    58]),                        # tfbind8, ragged amp
])
def test_decode_attention_kernel_matches_plain_version(cuda, B, S, H, hd,
                                                       kv_valid):
    q, k, v, kv = _attn_inputs(B, S, H, hd, kv_valid, cuda)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    torch.testing.assert_close(out, ref_decode_attention(q, k, v, kv),
                               atol=1e-4, rtol=1e-4)
    assert torch.all(out[kv <= 0] == 0)


def test_decode_attention_refuses_grad_on_cuda(cuda):
    q, k, v, kv = _attn_inputs(2, 4, 2, 8, [1, 4], cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q.requires_grad_(True), k, v, kv)


# -- traj_logprob -----------------------------------------------------------------

def _traj_inputs(B, T, A, device, seed=0):
    """Time-major (T+1, B, A) logits and mask, handed over as the (B, T, A)
    transposed views the training path uses."""
    g = torch.Generator().manual_seed(seed)
    logits = 3 * torch.randn(T + 1, B, A, generator=g)
    mask = torch.rand(T + 1, B, A, generator=g) < 0.6
    actions = torch.randint(0, A, (T, B), generator=g)
    mask[torch.arange(T)[:, None], torch.arange(B)[None, :], actions] = True
    valid = torch.arange(T)[:, None] < torch.randint(1, T + 1, (1, B),
                                                     generator=g)
    return (logits.to(device)[:-1].transpose(0, 1),
            actions.to(device).T, mask.to(device)[:-1].transpose(0, 1),
            valid.to(device).T)


@pytest.mark.parametrize("B,T,A", [(16, 15, 3840), (16, 15, 15),
                                   (3, 50, 203), (4, 5, 8192), (16, 8, 4),
                                   (16, 8, 1), (16, 5, 22), (128, 61, 21),
                                   (256, 8, 4)])
def test_traj_logprob_kernels_match_plain_version(cuda, B, T, A):
    """A = 8192 takes two chunks of the 16-byte path (the backward reads
    each chunk twice)."""
    logits, actions, mask, valid = _traj_inputs(B, T, A, cuda, seed=A)
    g = torch.Generator().manual_seed(1)
    g_total = torch.randn(B, generator=g).to(cuda)
    g_step = torch.randn(T, B, generator=g).to(cuda).T
    f0, b0 = ops.traj_logprob.launches, ops.traj_logprob_backward.launches
    lg = logits.detach().requires_grad_(True)
    total, per_step = ops.traj_logprob(lg, actions, mask, valid)
    ((total * g_total).sum() + (per_step * g_step).sum()).backward()
    torch.cuda.synchronize()
    assert ops.traj_logprob.launches == f0 + 1
    assert ops.traj_logprob_backward.launches == b0 + 1
    want_total, want_step = ref_traj_logprob(logits, actions, mask, valid)
    torch.testing.assert_close(per_step, want_step, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(total, want_total, atol=1e-4, rtol=1e-4)
    # entry by entry: most are coeff * softmax terms of ~1e-5, so each is
    # held to 1e-4 of its own size; the taken action's, coeff * (1 - p),
    # cancels as p nears 1 and is held to 1e-4 of |coeff|
    want = ref_traj_logprob_backward(logits, actions, mask, valid, g_total,
                                     g_step)
    coeff = ((g_total[:, None] + g_step) * valid).abs()
    scale = want.abs().scatter(-1, actions.long()[..., None],
                               coeff[..., None])
    assert torch.all((lg.grad - want).abs() <= 1e-8 + 1e-4 * scale)
    with torch.no_grad():        # no float atomics: runs agree bit for bit
        again = ops.traj_logprob(logits, actions, mask, valid)
    assert torch.equal(again[0], total) and torch.equal(again[1], per_step)


def test_traj_logprob_backward_dead_rows_are_exact_zeros(cuda):
    """The backward at the training shape (16, 15, 3840) on the time-major
    views, with one dead row (valid 0) and one row whose cotangents sum to
    0: entry by entry within 1e-4 of the plain version's own size (the
    taken action's entry within 1e-4 of |coeff|), and exactly 0 on those
    two rows."""
    B, T, A = 16, 15, 3840
    logits, actions, mask, valid = _traj_inputs(B, T, A, cuda, seed=11)
    valid = valid.clone()
    valid[:, 0] = True
    valid[3, 0] = False                                   # dead row
    g = torch.Generator().manual_seed(2)
    g_total = torch.randn(B, generator=g).to(cuda)
    g_step = torch.randn(T, B, generator=g).to(cuda).T.clone()
    g_step[5, 0] = -g_total[5]                            # zero cotangent
    b0 = ops.traj_logprob_backward.launches
    got = ops.traj_logprob_backward(logits, actions, mask, valid, g_total,
                                    g_step)
    torch.cuda.synchronize()
    assert ops.traj_logprob_backward.launches == b0 + 1
    want = ref_traj_logprob_backward(logits, actions, mask, valid, g_total,
                                     g_step)
    coeff = ((g_total[:, None] + g_step) * valid).abs()
    scale = want.abs().scatter(-1, actions.long()[..., None],
                               coeff[..., None])
    assert torch.all((got - want).abs() <= 1e-8 + 1e-4 * scale)
    assert torch.all(got[3, 0] == 0) and torch.all(got[5, 0] == 0)
    assert torch.all(got[~valid] == 0)


def _kernel_launches(fn, match):
    """The CUDA kernels ``fn`` launches whose name holds ``match``, counted
    by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and match in e.key)


def _misaligned(x):
    """A copy of ``x`` whose data starts one element past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("layout", [
    "time-major 3840", "contiguous 3840", "A=15", "A=203", "misaligned 3840",
    "misaligned 203"])
def test_traj_logprob_forward_is_one_launch_on_both_paths(cuda, layout):
    """The forward kernel's 16-byte path (A = 3840 on 16-byte boundaries,
    through the training path's transposed views or contiguous) and its
    scalar path (A = 15, 203, a view one element off a 16-byte boundary):
    held to the plain version, bitwise equal on repeat, and one CUDA kernel
    per call, per_step and total together."""
    A = int(layout.split()[-1].split("=")[-1])
    B, T = (16, 15) if A != 203 else (3, 50)
    logits, actions, mask, valid = _traj_inputs(B, T, A, cuda, seed=7)
    if not layout.startswith("time-major"):
        logits, mask = logits.contiguous(), mask.contiguous()
    if layout.startswith("misaligned"):
        logits, mask = _misaligned(logits), _misaligned(mask)
        assert logits.data_ptr() % 16 and mask.data_ptr() % 16
    with torch.no_grad():
        before = ops.traj_logprob.launches
        total, per_step = ops.traj_logprob(logits, actions, mask, valid)
        again = ops.traj_logprob(logits, actions, mask, valid)
        torch.cuda.synchronize()
        assert ops.traj_logprob.launches == before + 2
        assert torch.equal(again[0], total) and torch.equal(again[1],
                                                             per_step)
        assert _kernel_launches(
            lambda: ops.traj_logprob(logits, actions, mask, valid),
            "traj_logprob") == 1
    want_total, want_step = ref_traj_logprob(logits, actions, mask, valid)
    torch.testing.assert_close(per_step, want_step, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(total, want_total, atol=1e-4, rtol=1e-4)


def test_traj_logprob_forward_without_steps_is_zero(cuda):
    logits, actions, mask, valid = _traj_inputs(4, 3, 32, cuda)
    with torch.no_grad():
        total, per_step = ops.traj_logprob(logits[:, :0], actions[:, :0],
                                           mask[:, :0], valid[:, :0])
    assert torch.equal(total, torch.zeros(4, device=cuda))
    assert per_step.shape == (4, 0)


def test_training_on_cuda_launches_the_kernels(cuda):
    """Two bitseq_tb iterations at n=16, k=4 on the card: every cached
    query goes through decode_attention (3 layers x 4 steps), the loss
    through two traj_logprob forwards and one backward."""
    from repro_torch.run import run_recipe
    counts = (ops.decode_attention, ops.traj_logprob,
              ops.traj_logprob_backward)
    before = [c.launches for c in counts]
    out = run_recipe("bitseq_tb", iterations=2, env={"n": 16, "k": 4},
                     device=cuda, eval_every=0, log=lambda s: None)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [24, 4, 2]
    assert all(math.isfinite(r["loss"]) for r in out["history"])


def test_fused_step_follows_adam_on_cuda(cuda):
    """The fused step's weight cache is filled, then the policy trains two
    iterations with torch's Adam on the card (its CUDA implementation, not
    the CPU's): the cache must hold the live weights afterwards, and the
    fused step must equal the plain apply_cached + sample_masked chain."""
    from repro_torch.algo import TrainLoop
    from repro_torch.core.types import hash_gumbel, sample_masked
    from repro_torch.nn.transformer import decoder_stacked_weights
    recipe = recipes.get_train("bitseq_tb")
    env = recipe.make_env(n=16, k=4, seed=0)
    params = env.init(cuda)
    policy = recipe.make_policy(env, seed=0, device=cuda, requires_grad=True)
    before = {k: v.clone()
              for k, v in policy.kernel_weights()["stacked"].items()}
    TrainLoop(env, params, policy, recipe.make_config(env, 4)).run(0, 2)
    live = decoder_stacked_weights(policy.params["decoder"])
    cached = policy.kernel_weights()["stacked"]
    assert not torch.equal(before["ff1_w"], live["ff1_w"])
    for k in live:
        assert torch.equal(cached[k], live[k]), k
    B = 5
    _, state = env.reset(B, params)
    prev = torch.zeros(B, dtype=torch.int64, device=cuda)
    token, pos, length = env.observe_last(state, params, prev)
    ids = torch.arange(B, dtype=torch.int64, device=cuda)
    gumbel = hash_gumbel(torch.full_like(ids, 3), ids, torch.zeros_like(ids),
                         env.action_dim)
    mask = env.forward_mask(state, params)
    with torch.no_grad():
        out, _ = policy.apply_cached(policy.cache_init(B), token, pos,
                                     length, step=0)
        a_p, lp_p = sample_masked(out["logits"], mask, gumbel)
        a_f, lp_f, _, _ = policy.sample_cached(policy.cache_init(B), token,
                                               pos, length, gumbel, mask,
                                               step=0)
    assert torch.equal(a_f.long(), a_p)
    torch.testing.assert_close(lp_f, lp_p, atol=1e-4, rtol=1e-4)


# -- subtb_loss -------------------------------------------------------------------

def _subtb_inputs(B, T1, device, seed=0, walk=False, offset=0.0):
    """Time-major potentials (T+1, B), N(0, 1) or a random walk along T,
    plus ``offset``, handed over as the (B, T+1) view the loss passes, and
    lengths starting T, 0, 1 (a single row gets T)."""
    g = torch.Generator().manual_seed(seed)
    phi_tm = torch.randn(T1, B, generator=g)
    if walk:
        phi_tm = phi_tm.cumsum(0)
    phi_tm = phi_tm + offset
    length = torch.randint(0, T1, (B,), generator=g)
    length[:3] = torch.tensor([T1 - 1, 0, 1])[:B]
    return phi_tm.to(device).T, length.to(device)


@pytest.mark.parametrize("B,T1,lam", [(16, 30, 0.9), (16, 78, 0.9),
                                      (3, 100, 0.8), (1, 7, 0.5),
                                      (4, 200, 0.99), (3, 7000, 0.999)])
def test_subtb_kernels_match_plain_version(cuda, B, T1, lam):
    """Forward rtol 1e-4 (fp32 sums in another order), backward to 1e-4 of
    its largest entry; T+1 <= 32 takes the warp layout, the rest the block
    layout ((3, 7000): 896 threads, runs of 8 states)."""
    phi, length = _subtb_inputs(B, T1, cuda, seed=T1)
    g = torch.linspace(-1.0, 2.0, B, device=cuda)
    f0, b0 = ops.subtb_loss.launches, ops.subtb_loss_backward.launches
    x = phi.detach().requires_grad_(True)
    loss = ops.subtb_loss(x, length, lam)
    (loss * g).sum().backward()
    torch.cuda.synchronize()
    assert ops.subtb_loss.launches == f0 + 1
    assert ops.subtb_loss_backward.launches == b0 + 1
    torch.testing.assert_close(loss, ref_subtb(phi, length, lam),
                               rtol=1e-4, atol=0)
    assert torch.all(loss.detach()[length == 0] == 0)  # n = 0
    want = ref_subtb_backward(phi, length, lam, g)
    assert float((x.grad - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    with torch.no_grad():        # no float atomics: runs agree bit for bit
        assert torch.equal(ops.subtb_loss(phi, length, lam), loss.detach())


@pytest.mark.parametrize("B,T1,lam,walk", [(16, 30, 0.9, False),
                                           (3, 7000, 0.999, False),
                                           (3, 7000, 0.999, True),
                                           (3, 7000, 1.0, False),
                                           (2, 9000, 0.999, True)])
def test_subtb_kernels_hold_at_an_offset(cuda, B, T1, lam, walk):
    """Potentials at the level log Z gives them (offset 1e3), N(0, 1) or a
    random walk, where JAX's expanded prefix form cancels: the forward
    within 1e-4 (relative), the backward within 1e-4 of each trajectory's
    largest entry, n = 0 rows exactly 0, a repeat bitwise equal.  9,000
    states take two tiles of the block layout (8 states x 1,024 threads
    each)."""
    phi, length = _subtb_inputs(B, T1, cuda, seed=T1 + 3, walk=walk,
                                offset=1e3)
    g = torch.linspace(-1.0, 2.0, B, device=cuda)
    loss = ops.subtb_loss(phi, length, lam)
    dphi = ops.subtb_loss_backward(phi, length, g, lam)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, ref_subtb(phi, length, lam),
                               rtol=1e-4, atol=0)
    want = ref_subtb_backward(phi, length, lam, g)
    scale = want.abs().amax(1)
    live = scale > 0
    err = (dphi - want).abs().amax(1)
    assert torch.all(err[live] <= 1e-4 * scale[live])
    assert torch.all(dphi[~live] == 0)
    assert torch.all(loss[length == 0] == 0)
    assert torch.all(dphi[length == 0] == 0)
    assert torch.equal(ops.subtb_loss(phi, length, lam), loss)
    assert torch.equal(ops.subtb_loss_backward(phi, length, g, lam), dphi)


def test_subtb_on_cuda_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ops, "ref_subtb", refuse)
    monkeypatch.setattr(ops, "ref_subtb_backward", refuse)
    phi, length = _subtb_inputs(16, 30, cuda)
    x = phi.detach().requires_grad_(True)
    ops.subtb_loss(x, length, 0.9).sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()


def test_hypergrid_subtb_iteration_on_cuda(cuda):
    """One hypergrid_subtb iteration at full size (4x8^4, 16 envs, MLP
    2x256) with its evals: one SubTB forward and one backward launch, and
    two traj_logprob launches for the log Z bounds, none in training."""
    from repro_torch.run import run_recipe
    counts = (ops.subtb_loss, ops.subtb_loss_backward, ops.traj_logprob,
              ops.traj_logprob_backward)
    before = [c.launches for c in counts]
    out = run_recipe("hypergrid_subtb", iterations=1, device=cuda,
                     eval_every=1, log=lambda s: None)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [1, 1, 2, 0]
    assert math.isfinite(out["history"][0]["loss"])
    assert [r["step"] for r in out["rows"]] == [0]
    assert all(math.isfinite(v) for v in out["rows"][0].values())


@pytest.mark.parametrize("recipe,env,per_iteration", [
    ("tfbind8_tb", {}, [16, 2, 1]),
    ("qm9_tb", {}, [0, 2, 1]),
    ("amp_tb", {}, [183, 0, 0]),
])
def test_sequence_recipe_iteration_on_cuda(cuda, recipe, env, per_iteration):
    """One iteration of each sequence-design recipe at full width on the
    card: its decode_attention, traj_logprob forward and backward launches
    (AMP: 61 steps x 3 layers of cached queries, its stop-action loss
    takes no traj_logprob), then the same iteration on the CPU from the
    same parameters and noise: actions equal, loss to 1e-5 relative, each
    gradient to 1e-4 of its largest entry."""
    from repro_torch.algo import TrainLoop
    counts = (ops.decode_attention, ops.traj_logprob,
              ops.traj_logprob_backward)
    rec = recipes.get_train(recipe)
    environment = rec.make_env(**env)
    cfg = rec.make_config(environment, 16, rec.iterations)
    pol_g = rec.make_policy(environment, seed=1, device=cuda,
                            requires_grad=True)
    pol_c = rec.make_policy(environment, seed=1, device="cpu",
                            requires_grad=True)
    loop_g = TrainLoop(environment, environment.init(cuda), pol_g, cfg)
    loop_c = TrainLoop(environment, environment.init("cpu"), pol_c, cfg)
    st_g, st_c = loop_g.init(seed=5), loop_c.init(seed=5)
    before = [c.launches for c in counts]
    batch_g = loop_g.sample(st_g)
    loss_g = float(loop_g.loss_and_grads(batch_g))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == per_iteration
    batch_c = loop_c.sample(st_c)
    assert torch.equal(batch_g.actions.cpu(), batch_c.actions)
    cpu_batch = type(batch_g)(**{f.name: getattr(batch_g, f.name).cpu()
                                 for f in dataclasses.fields(batch_g)})
    loss_c = float(loop_c.loss_and_grads(cpu_batch))
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    grads_c = {k: p.grad for k, p in pol_c.params.flat().items()}
    for k, p in pol_g.params.flat().items():
        scale = float(grads_c[k].abs().max())
        assert float((p.grad.cpu() - grads_c[k]).abs().max()) <= 1e-4 * scale


# -- flash_attention and rwkv6_scan ------------------------------------------------

def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|), compared in fp32."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    assert err <= tol * scale, (err, scale)


def _close_bf16(got, want):
    """|got - want| <= 2^-7 |want| + 1e-3 rms(want) entry by entry, in
    fp32: one bf16 rounding of the same fp32 value on both sides."""
    got, want = got.float(), want.float()
    allowed = 2.0 ** -7 * want.abs() + 1e-3 * want.square().mean().sqrt()
    excess = (got - want).abs() - allowed
    assert float(excess.max()) <= 0, (float(excess.max()),
                                      float(want.abs().median()))


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, D, causal, window, q_offset, kv_len, bf16)
    (2, 128, 128, 4, 2, 64, True, 0, 0, None, False),
    (1, 100, 100, 8, 8, 32, True, 0, 0, None, False),
    (2, 64, 256, 4, 1, 128, False, 0, 0, None, False),
    (1, 256, 256, 4, 2, 64, True, 64, 0, None, False),
    (1, 64, 64, 2, 2, 64, True, 0, 0, None, True),
    (1, 17, 33, 2, 1, 16, True, 0, 0, None, False),       # ragged
    (2, 17, 64, 4, 2, 32, True, 16, 40, 57, False),       # cached prefill
    (1, 300, 300, 25, 5, 64, True, 128, 0, None, True),   # Hymba's heads
    (2, 1, 9, 4, 2, 24, True, 0, 8, None, False),         # one query
    # bf16 on the tensor cores: D 128 non-causal, ragged, windowed GQA,
    # cached prefill, one query row, D < 64 and between 64 and 128, a ring
    # of key tiles that wraps many times
    (2, 64, 256, 4, 1, 128, False, 0, 0, None, True),
    (1, 17, 33, 2, 1, 16, True, 0, 0, None, True),
    (2, 300, 300, 25, 5, 64, True, 100, 0, None, True),
    (2, 17, 64, 4, 2, 32, True, 16, 40, 57, True),
    (2, 200, 700, 4, 2, 128, True, 300, 450, 640, True),
    (2, 1, 9, 4, 2, 64, True, 0, 8, None, True),
    (1, 130, 190, 4, 2, 48, True, 0, 60, None, True),
    (2, 257, 1000, 8, 2, 96, True, 300, 700, None, True),
    (1, 512, 2048, 5, 1, 128, True, 0, 1536, None, True),
    (1, 64, 64, 2, 2, 24, True, 0, 0, None, True),        # bf16, SIMT
], ids=str)
def test_flash_attention_kernel_matches_plain_version(cuda, case):
    B, Sq, Skv, H, KVH, D, causal, window, q_offset, kv_len, bf16 = case
    g = torch.Generator().manual_seed(Sq)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dt) for shape in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    route = "wgmma" if bf16 and D % 16 == 0 else "simt"
    assert ops.flash_route(dt, D) == route
    before = ops.flash_attention.launches
    routes = dict(ops.flash_attention.route_launches)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.route_launches == {
        r: n + (r == route) for r, n in routes.items()}
    assert out.dtype == dt and out.shape == q.shape
    want = ref_flash_attention(q, k, v, **kw)
    if bf16:
        _close_bf16(out, want)
    else:
        _close(out, want, 1e-4)
    assert torch.equal(ops.flash_attention(q, k, v, **kw), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_rows_without_keys_are_zero_on_cuda(cuda, dtype):
    """kv_len = 0, then a negative q_offset that leaves the first 65 rows
    without a key (the bf16 operands take the tensor-core kernel)."""
    q, k, v = (torch.randn(s, device=cuda).to(dtype) for s in
               ((1, 70, 2, 16), (1, 70, 1, 16), (1, 70, 1, 16)))
    out = ops.flash_attention(q, k, v, causal=False, kv_len=0)
    assert torch.equal(out, torch.zeros_like(q))
    out = ops.flash_attention(q, k, v, causal=True, q_offset=-65)
    want = ref_flash_attention(q, k, v, causal=True, q_offset=-65)
    if dtype == torch.bfloat16:
        _close_bf16(out, want)
    else:
        _close(out, want, 1e-4)
    assert torch.equal(out[:, :65], torch.zeros_like(out[:, :65]))


def test_flash_attention_refuses_grad_and_strided_operands(cuda):
    q, k, v = (torch.randn(s, device=cuda) for s in
               ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.flash_attention(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    # bf16 at D = 16 takes the tensor-core route, whose TMA maps need
    # 16-byte boundaries: a contiguous view one element off one is refused
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    off = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(off, kb, vb)


@pytest.mark.parametrize("case", [
    # (B, T, H, Dk, Dv, bonus, state, bf16)
    (2, 64, 2, 16, 16, True, False, False),
    (1, 100, 3, 32, 32, True, True, False),
    (2, 128, 2, 16, 64, False, True, False),
    (1, 48, 2, 16, 16, True, False, True),
    (2, 300, 25, 16, 64, False, True, True),   # Hymba's SSM heads
    (8, 1, 25, 16, 64, False, True, True),     # a decode step
    (1, 77, 4, 64, 64, True, True, False),     # RWKV6's heads
    (3, 33, 2, 8, 40, False, True, False),     # odd sizes
    (2, 70, 3, 24, 200, True, True, False),    # Dv past one column tile
], ids=str)
def test_rwkv6_scan_kernel_matches_plain_version(cuda, case, monkeypatch):
    """The step recurrence kernel (``scan_route`` held at "recurrence", so
    the bf16 case at T = 300 runs it too)."""
    B, T, H, Dk, Dv, bonus, state, bf16 = case
    g = torch.Generator().manual_seed(T)
    dt = torch.bfloat16 if bf16 else torch.float32
    rn = lambda *s: torch.randn(s, generator=g)
    r, k, v = rn(B, T, H, Dk).to(cuda, dt), rn(B, T, H, Dk).to(cuda, dt), \
        rn(B, T, H, Dv).to(cuda, dt)
    w = (0.35 + 0.6 * torch.sigmoid(rn(B, T, H, Dk))).to(cuda)
    u = (0.1 * rn(H, Dk)).to(cuda) if bonus else None
    s0 = rn(B, H, Dk, Dv).to(cuda) if state else None
    monkeypatch.setattr(ops, "scan_route", lambda dtype, steps: "recurrence")
    before = ops.rwkv6_scan.launches
    routes = dict(ops.rwkv6_scan.route_launches)
    o, S = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    assert ops.rwkv6_scan.route_launches == {
        "chunk": routes["chunk"], "recurrence": routes["recurrence"] + 1}
    assert o.dtype == dt and S.dtype == torch.float32
    # the plain version (the recurrence) and the chunk form, which agree
    # at these decays (no chunk's product falls below its 1e-30 clamp)
    for want_o, want_S in (ref_rwkv6(r, k, v, w, u, s0),
                           chunked_linear_attention_ref(r, k, v, w, u, s0)):
        if bf16:
            _close_bf16(o, want_o)
        else:
            _close(o, want_o, 1e-4)
        _close(S, want_S, 1e-4)


def test_rwkv6_scan_refuses_grad_on_cuda(cuda):
    r = torch.randn(1, 4, 2, 16, device=cuda)
    w = torch.full_like(r, 0.5)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.rwkv6_scan(r.clone().requires_grad_(True), r, r, w)


def _scan_inputs(B, T, H, Dk, Dv, bonus, state, decay, device, seed):
    """bf16 r, k, v ~ N(0, 1); w fp32 by ``decay``: "mild" 0.35 + 0.6
    sigmoid(N(0, 1)), "strong" log-uniform in [1e-8, 0.3] (a chunk's
    product far below JAX's 1e-30 clamp); u ~ 0.1 N(0, 1); a state."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g)
    bf = torch.bfloat16
    r, k, v = (rn(B, T, H, Dk).to(device, bf), rn(B, T, H, Dk).to(device, bf),
               rn(B, T, H, Dv).to(device, bf))
    if decay == "mild":
        w = 0.35 + 0.6 * torch.sigmoid(rn(B, T, H, Dk))
    else:
        lo, hi = math.log(1e-8), math.log(0.3)
        w = torch.exp(lo + (hi - lo) * torch.rand(B, T, H, Dk, generator=g))
    u = (0.1 * rn(H, Dk)).to(device) if bonus else None
    s0 = rn(B, H, Dk, Dv).to(device) if state else None
    return r, k, v, w.to(device), u, s0


@pytest.mark.parametrize("case", [
    # (B, T, H, Dk, Dv, bonus, state, decay)
    (2, 4096, 25, 16, 64, False, False, "mild"),    # Hymba's scoring call
    (2, 4096, 25, 16, 64, False, True, "strong"),
    (2, 300, 4, 64, 64, True, True, "mild"),        # RWKV6's heads
    (2, 300, 4, 64, 64, True, True, "strong"),
    (1, 1000, 5, 16, 64, True, True, "mild"),       # ragged T
    (2, 64, 3, 32, 64, False, True, "strong"),      # one chunk
    (1, 200, 3, 24, 200, True, True, "strong"),     # Dk 24, Dv past a tile
    (3, 130, 2, 8, 33, False, True, "mild"),        # odd Dv
    (2, 40, 3, 16, 64, True, True, "strong"),       # T < 64 (held to chunk)
], ids=str)
def test_rwkv6_chunk_kernel_matches_plain_version(cuda, case, monkeypatch):
    """The chunk route against the step recurrence, entry by entry, at mild
    and strong decays; one launch counted on the chunk route per call; a
    repeat call is bitwise equal."""
    B, T, H, Dk, Dv, bonus, state, decay = case
    r, k, v, w, u, s0 = _scan_inputs(B, T, H, Dk, Dv, bonus, state, decay,
                                     cuda, seed=T + Dk)
    if T < ops.SCAN_CHUNK:
        monkeypatch.setattr(ops, "scan_route", lambda dtype, steps: "chunk")
    assert ops.scan_route(torch.bfloat16, T) == "chunk"
    before = ops.rwkv6_scan.launches
    routes = dict(ops.rwkv6_scan.route_launches)
    o, S = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    assert ops.rwkv6_scan.route_launches == {
        "chunk": routes["chunk"] + 1, "recurrence": routes["recurrence"]}
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    want_o, want_S = ref_rwkv6(r, k, v, w, u, s0)
    _close_bf16(o, want_o)
    _close(S, want_S, 1e-4)
    o2, S2 = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert torch.equal(o2, o) and torch.equal(S2, S)


def test_scan_route_rule_and_the_chunk_route_on_cuda(cuda):
    """bf16 at T >= 64 takes the chunk kernel, fp32 and T = 1 the
    recurrence; the chunk route refuses grad and strided operands, and
    leaves the state it is given as it was."""
    assert ops.scan_route(torch.bfloat16, 64) == "chunk"
    assert ops.scan_route(torch.bfloat16, 4096) == "chunk"
    assert ops.scan_route(torch.bfloat16, 1) == "recurrence"
    assert ops.scan_route(torch.float32, 4096) == "recurrence"
    r, k, v, w, u, s0 = _scan_inputs(1, 128, 2, 16, 64, True, True, "mild",
                                     cuda, seed=0)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.rwkv6_scan(r.float().requires_grad_(True).to(torch.bfloat16), k,
                       v, w)
    with pytest.raises(ValueError, match="v must be contiguous"):
        ops.rwkv6_scan(r, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                       w)
    want = ops.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    o, state_out = ops.rwkv6_scan(r, k, v, w, u, state)
    assert torch.equal(o, want[0]) and torch.equal(state_out, want[1])
    assert torch.equal(state, s0)


def test_hymba_smoke_on_cuda_matches_the_cpu(cuda, monkeypatch):
    """Hymba's smoke config in fp32, the same parameters on both devices:
    a 20-token scoring pass (2 flash and 2 scan launches, one per layer)
    and 10 decode steps through the 8-slot window (2 scan launches each,
    no flash) equal the CPU's plain versions; on the card the plain
    versions never run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="float32")
    cpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    want = steps.make_prefill_step(cfg)({"model": cpu}, batch)
    cache_c = LM.init_cache(cfg, 2, 16)
    want_logits = [LM.decode_step(cpu, cfg, toks[:, t:t + 1], cache_c)[0]
                   for t in range(10)]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(ops, "ref_flash_attention", refuse)
    monkeypatch.setattr(ops, "ref_rwkv6", refuse)
    f0, s0 = ops.flash_attention.launches, ops.rwkv6_scan.launches
    got = steps.make_prefill_step(cfg)(
        {"model": gpu}, {k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - f0,
            ops.rwkv6_scan.launches - s0) == (2, 2)
    _close(got.cpu(), want, 1e-4)
    cache_g = LM.init_cache(cfg, 2, 16, device=cuda)
    f0, s0 = ops.flash_attention.launches, ops.rwkv6_scan.launches
    with torch.no_grad():
        for t in range(10):
            logits, cache_g = LM.decode_step(gpu, cfg,
                                             toks[:, t:t + 1].to(cuda),
                                             cache_g)
            _close(logits.cpu(), want_logits[t], 1e-4)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - f0,
            ops.rwkv6_scan.launches - s0) == (0, 20)
    _close(cache_g["ssm"].cpu(), cache_c["ssm"], 1e-4)
    assert torch.equal(cache_g["kv"]["pos"].cpu(), cache_c["kv"]["pos"])
