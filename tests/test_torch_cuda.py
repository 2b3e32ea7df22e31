"""The port on a CUDA GPU: the hand-written kernels (decode step, decode
attention, trajectory log-prob forward and backward, SubTB loss forward
and backward, flash attention and the RWKV6 scan, each forward and
backward on both of its routes)
against their plain PyTorch versions, the serving engine on the card
against ``forward_rollout``, two bitseq_tb training iterations, one
full-size hypergrid_subtb iteration, one iteration of each sequence-design
recipe (tfbind8_tb, qm9_tb, amp_tb) and of each graph recipe (dag_mdb,
phylo_fldb, captured too) and Hymba's smoke config (scoring and decode)
on the card against the CPU; a training iteration captured in a CUDA
graph against eager ones, the checks that capture keeps, and the DAG
posterior's JSD on the card against the CPU; the continuous Box recipes
(box_tb, box_db): an iteration on the card against the CPU, captured
against eager (bitwise), a host read refused, the quadrature eval; replay
training (the FIFO buffer and the replay samplers in the captured
iteration, bitwise eager, a host read refused) and the pop-only cached
backward through decode_attention; the training CLI's state: a captured
iteration with the clip, weight decay and a scheduled beta bitwise eager,
a resume from a checkpoint bitwise the uninterrupted run.  Imports no JAX, so it runs on a machine with a GPU and no JAX:

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
    # iteration 0 runs eagerly, iteration 1 replays its capture
    captured = out["loop"].captured
    assert captured.replays == 1
    assert [captured.launches[k] for k in (
        "decode_attention", "traj_logprob_fwd", "traj_logprob_bwd")] \
        == [12, 2, 1]
    assert [c.launches - b for c, b in zip(counts, before)] == [12, 2, 1]
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


# -- captured training iterations ---------------------------------------------------

def _hypergrid_loop(cuda, noise=None):
    from repro_torch.algo import OnPolicySampler, TrainLoop
    rec = recipes.get_train("hypergrid_subtb")
    env = rec.make_env(dim=2, side=4)
    policy = rec.make_policy(env, seed=3, device=cuda, requires_grad=True)
    sampler = None if noise is None else OnPolicySampler(noise=noise)
    return TrainLoop(env, env.init(cuda), policy,
                     rec.make_config(env, 16, 100), sampler=sampler)


def _three_iterations(cuda, captured):
    """Losses of three iterations and the parameters after them, eager or
    through a captured iteration (iteration 0 eager, then two replays)."""
    loop = _hypergrid_loop(cuda)
    state = loop.init(seed=4)
    if captured:
        graph = loop.capture(state)
        outs = [graph.warmup[0]["loss"].clone()]
        outs += [graph()[0]["loss"].clone() for _ in range(2)]
    else:
        outs = [loop.step(state)[1]["loss"] for _ in range(3)]
        graph = None
    torch.cuda.synchronize()
    return (torch.stack(outs), {k: v.detach().clone() for k, v in
                                loop.policy.params.flat().items()}, graph)


def test_captured_iteration_matches_eager(cuda):
    """A small hypergrid_subtb run (2x4 grid, MLP 2x256, 16 envs) through
    a captured iteration against two eager runs from the same parameters
    and seed: the replays' losses and the parameters after them agree as
    closely as the two eager runs agree with each other (bitwise where
    they are bitwise); one replay launches the SubTB pair once each."""
    loss_a, par_a, _ = _three_iterations(cuda, captured=False)
    loss_b, par_b, _ = _three_iterations(cuda, captured=False)
    loss_c, par_c, graph = _three_iterations(cuda, captured=True)
    tol = max([float((loss_a - loss_b).abs().max())]
              + [float((par_a[k] - par_b[k]).abs().max()) for k in par_a])
    assert float((loss_c - loss_a).abs().max()) <= tol
    for k in par_a:
        assert float((par_c[k] - par_a[k]).abs().max()) <= tol, k
    assert graph.replays == 2
    assert {k: v for k, v in graph.launches.items() if v} == {
        "subtb_loss_fwd": 1, "subtb_loss_bwd": 1}


def test_capture_refuses_a_host_read(cuda):
    """A noise source that reads the seed on the host cannot be captured:
    the warm-up raises (sync debug mode), and nothing runs eagerly in its
    place."""
    from repro_torch.core.types import hash_step_noise

    def host_read(seed, index, t, num_actions):
        int(seed[0])
        return hash_step_noise(seed, index, t, num_actions)

    loop = _hypergrid_loop(cuda, noise=host_read)
    with pytest.raises(RuntimeError):
        loop.run(0, 3)
    assert loop.captured is None


def test_subtb_length_check_fails_under_capture(cuda):
    """Inside a capture the SubTB wrapper cannot read the lengths on the
    host; it counts a bad call on the device at every replay, and
    ``check_device_errors`` raises on it after the replay."""
    g = torch.Generator().manual_seed(0)
    phi = torch.randn(4, 8, generator=g).to(cuda)
    length = torch.tensor([0, 7, 3, 5], device=cuda)
    ops.subtb_loss(phi, length, 0.9)            # build and load the kernels
    ops.check_device_errors(cuda)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        loss = ops.subtb_loss(phi, length, 0.9)
    want = ref_subtb(phi.cpu(), length.cpu(), 0.9)
    graph.replay()
    torch.cuda.synchronize()
    ops.check_device_errors(cuda)               # good lengths: no error
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-4, atol=1e-4)
    length.copy_(torch.tensor([0, 8, 3, -1]))
    graph.replay()
    with pytest.raises(ValueError, match="lengths must lie"):
        ops.check_device_errors(cuda)
    ops.check_device_errors(cuda)               # the count was cleared
    with pytest.raises(ValueError, match="lengths must lie"):
        ops.subtb_loss(phi, length, 0.9)        # eager: the host check


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


@pytest.mark.parametrize("recipe,env,per_iteration", [
    ("dag_mdb", {}, [0, 0, 0]),
    ("phylo_fldb", {"reduced": True}, [0, 2, 2]),
])
def test_graph_recipe_iteration_on_cuda(cuda, recipe, env, per_iteration):
    """One iteration of each graph recipe at its own batch on the card:
    dag_mdb at d = 5 (MDB's stop-action loss launches no kernel),
    phylo_fldb on the reduced alignment (P_F and the learned P_B each one
    traj_logprob forward and backward); then the same iteration on the CPU
    from the same parameters and noise: actions equal, loss to 1e-5
    relative, each gradient to 1e-4 of its largest entry or 1e-5 (the
    backward head's bias has a zero gradient up to rounding)."""
    from repro_torch.algo import TrainLoop
    counts = (ops.decode_attention, ops.traj_logprob,
              ops.traj_logprob_backward)
    rec = recipes.get_train(recipe)
    environment = rec.make_env(**env)
    cfg = rec.make_config(environment, rec.num_envs, rec.iterations)
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
    torch.testing.assert_close(batch_g.log_r_state.cpu(),
                               batch_c.log_r_state, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(batch_g.energy.cpu(), batch_c.energy,
                               rtol=1e-6, atol=1e-6)
    cpu_batch = type(batch_g)(**{f.name: getattr(batch_g, f.name).cpu()
                                 for f in dataclasses.fields(batch_g)})
    loss_c = float(loop_c.loss_and_grads(cpu_batch))
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    grads_c = {k: p.grad for k, p in pol_c.params.flat().items()}
    for k, p in pol_g.params.flat().items():
        scale = float(grads_c[k].abs().max())
        err = float((p.grad.cpu() - grads_c[k]).abs().max())
        assert err <= max(1e-4 * scale, 1e-5), (k, err, scale)


@pytest.mark.parametrize("recipe,env", [("dag_mdb", {}),
                                        ("phylo_fldb", {"reduced": True})])
def test_graph_recipe_capture_matches_eager(cuda, recipe, env):
    """Three iterations of each graph recipe through a captured iteration
    (its warm-up under sync debug mode "error": a host read in the DAG or
    phylo env's steps, the per-state log R or energy, or the phylo policy
    raises) against two eager runs: losses and parameters as close as the
    eager runs are to each other, bitwise where they are bitwise."""
    from repro_torch.algo import TrainLoop
    rec = recipes.get_train(recipe)
    environment = rec.make_env(**env)
    params = environment.init(cuda)
    cfg = rec.make_config(environment, rec.num_envs, 100)

    def three(captured):
        policy = rec.make_policy(environment, seed=2, device=cuda,
                                 requires_grad=True)
        loop = TrainLoop(environment, params, policy, cfg)
        state = loop.init(seed=3)
        if captured:
            graph = loop.capture(state)
            outs = [graph.warmup[0]["loss"].clone()]
            outs += [graph()[0]["loss"].clone() for _ in range(2)]
        else:
            outs = [loop.step(state)[1]["loss"] for _ in range(3)]
        torch.cuda.synchronize()
        return torch.stack(outs), {k: v.detach().clone() for k, v in
                                   policy.params.flat().items()}

    (la, pa), (lb, pb), (lc, pc) = three(False), three(False), three(True)
    tol = max([float((la - lb).abs().max())]
              + [float((pa[k] - pb[k]).abs().max()) for k in pa])
    assert float((lc - la).abs().max()) <= tol
    for k in pa:
        assert float((pc[k] - pa[k]).abs().max()) <= tol, k
    assert torch.isfinite(lc).all()


def test_posterior_jsd_on_cuda_matches_cpu(cuda):
    """The device JSD of the same 4,000 DAGs (d = 5, 29,281 DAGs) on the
    card and on the CPU; and a full eval call (a rollout of 4,000) on the
    card in [0, log 2]."""
    from repro_torch.recipes.dag import PosteriorJSDEval, dag_env
    from repro_torch.rewards.bayesnet import enumerate_dags
    env = dag_env()
    ev_g = PosteriorJSDEval(env, env.init(cuda), policy=None)
    ev_c = PosteriorJSDEval(env, env.init("cpu"), policy=None)
    dags = torch.as_tensor(enumerate_dags(5))
    g = torch.Generator().manual_seed(0)
    adj = dags[torch.randint(0, dags.shape[0], (4000,), generator=g)]
    assert torch.equal(ev_g.indices(adj.to(cuda)).cpu(), ev_c.indices(adj))
    torch.testing.assert_close(ev_g.jsd(adj.to(cuda)).cpu(), ev_c.jsd(adj),
                               rtol=1e-5, atol=1e-7)
    ev_g.policy = recipes.get_train("dag_mdb").make_policy(env, device=cuda)
    jsd = float(ev_g(0)["jsd"])
    assert 0 <= jsd <= math.log(2)


# -- EB-GFN on the Ising model -----------------------------------------------------

def _ising_loop(device, policy_seed=1, noise=None, iterations=8):
    """ising_ebgfn at n = 6 (sigma -0.1, 64 data rows, 64 envs) with the
    recipe's MLP 4x256 and a learned P_B."""
    from repro_torch.core.ebgfn import EBGFN_NOISE
    from repro_torch.recipes.ising import ising_env, ising_loop, ising_policy
    env = ising_env(n=6)
    policy = ising_policy(env, seed=policy_seed, device=device,
                          requires_grad=True)
    loop = ising_loop(env, policy, seed=0, iterations=iterations,
                      num_envs=64, num_data=64)
    loop.noise = noise or EBGFN_NOISE
    return loop


def test_ising_iteration_on_cuda_matches_cpu(cuda):
    """One EB-GFN iteration on the card against the CPU from the same
    policy, J (a seeded symmetric draw, its energies the size of the
    log P_T terms, so the MH test rejects some rows), data rows and noise.
    The GFN update: the mix coin and both rollouts' actions equal, and the
    CPU's TB loss and gradients on the card's batch to 1e-5 relative and
    1e-4 of each tensor's largest entry (or 1e-5).  The MH test, rerun
    collecting on each device from the card's updated policy (the card's
    rerun bitwise its iteration's): the negatives' and the MH rollout's
    actions equal, log A to 1e-4 of its terms' magnitude, the outcome
    equal where |log u - log A| > 1e-3.  The CPU's ``cd_step`` on the
    card's rows, negatives and outcome: J's gradient and J to 1e-4.  Two
    traj_logprob forwards and two backwards on the card."""
    from repro_torch.algo.loop import loss_and_grads
    from repro_torch.core.objectives import evaluate_trajectory, tb_parts
    from repro_torch.core.types import train_seed
    cpu = torch.device("cpu")
    counts = (ops.traj_logprob, ops.traj_logprob_backward)
    loop_g, loop_c = _ising_loop(cuda), _ising_loop(cpu)
    loop_c.policy.load_params({k: v.detach().cpu() for k, v in
                               loop_g.policy.params.flat().items()})
    J0 = torch.randn(36, 36, generator=torch.Generator().manual_seed(0))

    def state(loop):
        st = loop.init(seed=5)
        with torch.no_grad():
            st.J.copy_(J0 + J0.T)
        return st

    st_g, st_c, st_cd = state(loop_g), state(loop_c), state(loop_c)
    before = [c.launches for c in counts]
    m_g, batch_g, tr_g = loop_g.iteration_trace(st_g)
    assert [c.launches - b for c, b in zip(counts, before)] == [2, 2]
    cpu_batch = type(batch_g)(**{f.name: getattr(batch_g, f.name).cpu()
                                 for f in dataclasses.fields(batch_g)})
    pol = loop_c.policy
    loss_c = float(loss_and_grads(pol.params, *tb_parts(
        evaluate_trajectory(pol, cpu_batch), cpu_batch, pol.params["log_z"])))
    grads_c = {k: p.grad.clone() for k, p in pol.params.flat().items()}
    _, _, tr_c = loop_c.iteration_trace(st_c)
    assert torch.equal(tr_g.take_fwd.cpu(), tr_c.take_fwd)
    for name in ("fwd", "bwd"):
        for f in ("actions", "bwd_actions"):
            assert torch.equal(getattr(getattr(tr_g, name), f).cpu(),
                               getattr(getattr(tr_c, name), f)), (name, f)
    loss_g = float(m_g["gfn_loss"])
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, p in loop_g.policy.params.flat().items():
        scale = float(grads_c[k].abs().max())
        err = float((p.grad.cpu() - grads_c[k]).abs().max())
        assert err <= max(1e-4 * scale, 1e-5), (k, err, scale)
    # the MH test from the card's updated policy on both devices
    pol.load_params({k: v.detach().cpu() for k, v in
                     loop_g.policy.params.flat().items()})
    seed = train_seed(5, 0)
    t_g = loop_g.mh_test(torch.tensor(seed, device=cuda), tr_g.reward,
                         tr_g.data, collect=True)
    t_c = loop_c.mh_test(torch.tensor(seed), tr_c.reward, tr_c.data,
                         collect=True)
    for f in ("log_a", "accept"):
        assert torch.equal(getattr(t_g, f), getattr(tr_g.test, f)), f
    assert torch.equal(t_g.neg.actions.cpu(), t_c.neg.actions)
    assert torch.equal(t_g.mh.batch.bwd_actions.cpu(),
                       t_c.mh.batch.bwd_actions)
    x, J = tr_c.data.float(), tr_c.reward.reward_params["J"]
    x_neg = t_c.neg.obs[-1]
    terms = ((x @ J) * x).sum(-1).abs() + ((x_neg @ J) * x_neg).sum(-1).abs() \
        + t_c.mh.log_pf.abs() + t_c.mh.log_pb.abs() \
        + t_c.neg.log_pf_beh.abs().sum(0)
    assert bool(((t_g.log_a.cpu() - t_c.log_a).abs() <= 1e-4 * terms).all())
    torch.testing.assert_close(t_g.log_u.cpu(), t_c.log_u, rtol=1e-6, atol=0)
    clear = (t_c.log_u - t_c.log_a).abs() > 1e-3
    assert torch.equal(t_g.accept.cpu()[clear], t_c.accept[clear])
    assert t_c.accept.any() and not t_c.accept.all()
    # the energy update on the card's outcome
    loop_c.cd_step(st_cd, tr_g.data.cpu().float(),
                   tr_g.test.neg.obs[-1].cpu(), tr_g.test.accept.cpu())
    for got, want in ((st_g.J.grad, st_cd.J.grad), (st_g.J, st_cd.J)):
        got, want = got.detach().cpu(), want.detach()
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_ising_capture_matches_eager(cuda):
    """Three EB-GFN iterations through a captured iteration (its warm-up
    under sync debug mode "error") against two eager runs: the losses, the
    MH acceptance and every trained tensor (the policy and J) as close as
    the eager runs are to each other, bitwise where they are bitwise; one
    replay launches two traj_logprob forwards and two backwards."""
    def three(captured):
        loop = _ising_loop(cuda, policy_seed=2)
        state = loop.init(seed=3)

        def row(metrics):       # a copy: a replay's outputs are the graph's
            return torch.stack([metrics["gfn_loss"], metrics["mh_accept"]])

        if captured:
            graph = loop.capture(state)
            outs = [row(graph.warmup[0])] + [row(graph()[0])
                                             for _ in range(2)]
        else:
            graph = None
            outs = [row(loop.step(state)[1]) for _ in range(3)]
        outs = torch.stack(outs)
        torch.cuda.synchronize()
        return outs, {k: v.detach().clone() for k, v in
                      loop.trained(state).items()}, graph

    (la, pa, _), (lb, pb, _) = three(False), three(False)
    lc, pc, graph = three(True)
    tol = max([float((la - lb).abs().max())]
              + [float((pa[k] - pb[k]).abs().max()) for k in pa])
    assert "J" in pa
    assert float((lc - la).abs().max()) <= tol
    for k in pa:
        assert float((pc[k] - pa[k]).abs().max()) <= tol, k
    assert torch.isfinite(lc).all() and graph.replays == 2
    assert {k: v for k, v in graph.launches.items() if v} == {
        "traj_logprob_fwd": 2, "traj_logprob_bwd": 2}


def test_ising_capture_refuses_a_host_read(cuda):
    """A mix coin that reads the seed on the host cannot be captured: the
    warm-up raises, and nothing runs eagerly in its place."""
    from repro_torch.core.ebgfn import EBGFN_NOISE

    def host_read(seed, index):
        int(seed[0])
        return EBGFN_NOISE.take(seed, index)

    loop = _ising_loop(cuda, noise=EBGFN_NOISE._replace(take=host_read))
    with pytest.raises(RuntimeError):
        loop.run(0, 3)
    assert loop.captured is None


# -- the continuous Box ---------------------------------------------------------------

def _box_loop(device, recipe="box_tb", policy_seed=1, noise=None):
    from repro_torch.algo import OnPolicySampler, TrainLoop
    rec = recipes.get_train(recipe)
    env = rec.make_env()
    policy = rec.make_policy(env, seed=policy_seed, device=device,
                             requires_grad=True)
    sampler = None if noise is None else OnPolicySampler(noise=noise)
    return TrainLoop(env, env.init(device), policy,
                     rec.make_config(env, rec.num_envs, rec.iterations),
                     sampler=sampler)


@pytest.mark.parametrize("recipe", ["box_tb", "box_db"])
def test_box_iteration_on_cuda_matches_cpu(cuda, recipe):
    """One iteration at full width (64 envs, MLP 4 -> 128 -> 128 -> 50,
    K = 4) on the card and on the CPU from the same parameters and hash
    noise: done and exit flags equal (no draw of this seed sits within
    1e-5 of a tie), observations within 1e-5; on the card's batch, the
    loss to 1e-5 relative and each gradient to 1e-4 of its largest entry;
    no kernel wrapper launches."""
    counts = (ops.decode_attention, ops.traj_logprob,
              ops.traj_logprob_backward, ops.subtb_loss)
    loop_g = _box_loop(cuda, recipe)
    loop_c = _box_loop("cpu", recipe)
    loop_c.policy.load_params({k: v.detach().cpu() for k, v in
                               loop_g.policy.params.flat().items()})
    st_g, st_c = loop_g.init(seed=5), loop_c.init(seed=5)
    before = [c.launches for c in counts]
    batch_g = loop_g.sample(st_g)
    loss_g = float(loop_g.loss_and_grads(batch_g))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [0] * 4
    batch_c = loop_c.sample(st_c)
    assert torch.equal(batch_g.done.cpu(), batch_c.done)
    assert torch.equal(batch_g.actions[..., 2].cpu(), batch_c.actions[..., 2])
    assert float((batch_g.obs.cpu() - batch_c.obs).abs().max()) <= 1e-5
    cpu_batch = type(batch_g)(**{f.name: getattr(batch_g, f.name).cpu()
                                 for f in dataclasses.fields(batch_g)})
    loss_c = float(loop_c.loss_and_grads(cpu_batch))
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    grads_c = {k: p.grad for k, p in loop_c.policy.params.flat().items()}
    for k, p in loop_g.policy.params.flat().items():
        scale = float(grads_c[k].abs().max())
        err = float((p.grad.cpu() - grads_c[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


@pytest.mark.parametrize("recipe", ["box_tb", "box_db"])
def test_box_capture_is_bitwise_eager(cuda, recipe):
    """Three iterations through a captured iteration (its warm-up under
    sync debug mode "error": a host read in the flow hash, the env, the
    flow policy or the density path raises) against an eager run from the
    same parameters and seed: every iteration's actions, the losses and
    the parameters after them bitwise; a replay launches no kernel
    wrapper."""
    def snap(metrics, batch):   # a copy: the next replay overwrites them
        return metrics["loss"].clone(), batch.actions.clone()

    def three(captured):
        loop = _box_loop(cuda, recipe, policy_seed=2)
        state = loop.init(seed=3)
        if captured:
            graph = loop.capture(state)
            rows = [snap(*graph.warmup)] + [snap(*graph()) for _ in range(2)]
        else:
            graph = None
            rows = [snap(*loop.step(state)[1:]) for _ in range(3)]
        torch.cuda.synchronize()
        return rows, {k: v.detach().clone() for k, v in
                      loop.policy.params.flat().items()}, graph

    eager, pa, _ = three(False)
    capt, pc, graph = three(True)
    for (la, aa), (lc, ac) in zip(eager, capt):
        assert torch.equal(lc, la) and torch.equal(ac, aa)
    for k in pa:
        assert torch.equal(pc[k], pa[k]), k
    assert graph.replays == 2 and not any(graph.launches.values())


def test_box_capture_refuses_a_host_read(cuda):
    """A flow-noise source that reads the seed on the host cannot be
    captured: the warm-up raises, and nothing runs eagerly in its place."""
    from repro_torch.core.types import hash_flow_noise

    def host_read(seed, index, t, dims):
        int(seed[0])
        return hash_flow_noise(seed, index, t, dims)

    loop = _box_loop(cuda, noise=host_read)
    with pytest.raises(RuntimeError):
        loop.run(0, 3)
    assert loop.captured is None


# -- replay training: the buffer and the samplers in the captured iteration -------

def _replay_loop(device, recipe, sampler, select_noise=None, **kwargs):
    from repro_torch.algo import TrainLoop, make_sampler
    rec = recipes.get_train(recipe)
    env = rec.make_env(**({"dim": 2, "side": 4}
                          if recipe.startswith("hypergrid") else {}))
    policy = rec.make_policy(env, seed=2, device=device, requires_grad=True)
    if select_noise is not None:
        kwargs["select_noise"] = select_noise
    return TrainLoop(env, env.init(device), policy,
                     rec.make_config(env, 16, 100),
                     sampler=make_sampler(sampler, **kwargs))


@pytest.mark.parametrize("recipe,sampler,kwargs,per_iteration", [
    ("hypergrid_tb", "replay", {"capacity": 40, "prioritized": True}, {}),
    ("hypergrid_tb", "replay", {"capacity": 40, "replay_batch": 7}, {}),
    ("tfbind8_tb", "backward_replay", {},
     {"decode_attention": 16, "traj_logprob_fwd": 2,
      "traj_logprob_bwd": 1})])
def test_replay_capture_is_bitwise_eager(cuda, recipe, sampler, kwargs,
                                         per_iteration):
    """Four iterations of a replay sampler through a captured iteration
    (its warm-up under sync debug mode "error": a host read of the
    buffer's fill level or insert position raises) against an eager run
    from the same parameters and seed: every iteration's actions and
    loss, the parameters and the buffer (slots, insert position, fill
    level: a 40-slot buffer wraps) after them bitwise; a replay launches
    the kernels of one eager iteration."""
    def snap(metrics, batch):   # a copy: the next replay overwrites them
        return metrics["loss"].clone(), batch.actions.clone()

    def four(captured):
        loop = _replay_loop(cuda, recipe, sampler, **kwargs)
        state = loop.init(seed=3)
        if captured:
            graph = loop.capture(state)
            rows = [snap(*graph.warmup)] + [snap(*graph()) for _ in range(3)]
        else:
            graph = None
            rows = [snap(*loop.step(state)[1:]) for _ in range(4)]
        torch.cuda.synchronize()
        buf = state.sampler
        return rows, {k: v.detach().clone() for k, v in
                      loop.policy.params.flat().items()}, \
            (buf.data, buf.insert_pos, buf.size), graph

    eager, pa, ba, _ = four(False)
    capt, pc, bc, graph = four(True)
    for (la, aa), (lc, ac) in zip(eager, capt):
        assert torch.equal(lc, la) and torch.equal(ac, aa)
    for k in pa:
        assert torch.equal(pc[k], pa[k]), k
    for k in ba[0]:
        assert torch.equal(bc[0][k], ba[0][k]), k
    assert torch.equal(bc[1], ba[1]) and torch.equal(bc[2], ba[2])
    assert int(ba[2]) == min(4 * 16, kwargs.get("capacity", 2048))
    assert graph.replays == 3
    assert {k: v for k, v in graph.launches.items() if v} == per_iteration


def test_replay_capture_refuses_a_host_read(cuda):
    """A selection-noise source that reads the seed on the host cannot be
    captured: the warm-up raises, and nothing runs eagerly in its place."""
    from repro_torch.core.types import hash_select_noise

    def host_read(seed, index, capacity, prioritized):
        int(seed[0])
        return hash_select_noise(seed, index, capacity, prioritized)

    loop = _replay_loop(cuda, "hypergrid_tb", "replay", capacity=40,
                        select_noise=host_read)
    with pytest.raises(RuntimeError):
        loop.run(0, 3)
    assert loop.captured is None


def test_cached_backward_on_cuda_launches_decode_attention(cuda):
    """The pop-only cached backward on tfbind8 with the recipe's decode
    policy: one decode_attention launch per layer and step, and log P_F /
    log P_B within 1e-4 of the uncached rollout's, actions equal."""
    from repro_torch.core.rollout import backward_rollout, forward_rollout
    from repro_torch.kernels import ops
    rec = recipes.get_train("tfbind8_tb")
    env = rec.make_env()
    params = env.init(cuda)
    policy = rec.make_policy(env, seed=1, device=cuda)
    _, term = forward_rollout(3, env, params, policy, 16,
                              exploration_eps=0.5, return_final_state=True)
    before = ops.decode_attention.launches
    ca = backward_rollout(4, env, params, policy, term, collect=True)
    launched = ops.decode_attention.launches - before
    un = backward_rollout(4, env, params, policy, term, collect=True,
                          use_cache=False)
    assert launched == 2 * env.max_steps
    assert ops.decode_attention.launches - before == launched
    assert torch.equal(ca.batch.actions, un.batch.actions)
    torch.testing.assert_close(ca.log_pf, un.log_pf, atol=1e-4, rtol=0)
    torch.testing.assert_close(ca.log_pb, un.log_pb, atol=1e-4, rtol=0)


def _cli_stack_loop(device, transforms, sampler=None):
    """tfbind8_tb's loop over a transform stack, with AdamW's clip and
    weight decay (the training CLI's ``--cfg``), policy seed 1."""
    from repro_torch.algo import TrainLoop
    from repro_torch.envs.transforms import apply_transforms
    rec = recipes.get_train("tfbind8_tb")
    env = apply_transforms(rec.make_env(), transforms)
    cfg = rec.make_config(env, 16, 100)._replace(max_grad_norm=1.0,
                                                 weight_decay=1e-4)
    return TrainLoop(env, env.init(device),
                     rec.make_policy(env, seed=1, device=device,
                                     requires_grad=True), cfg,
                     sampler=sampler)


def test_capture_with_clip_decay_and_scheduled_beta_is_bitwise_eager(cuda):
    """tfbind8 under ``reward_cache`` and a beta annealed over 4
    iterations, with the clip and weight decay: four captured iterations
    (the warm-up under sync debug mode "error": the clip's norm, AdamW's
    decay and the beta schedule read no host value) against four eager
    ones from the same state: actions, losses and parameters bitwise,
    while beta moves every iteration."""
    stack = ("reward_cache",
             "reward_exponent:beta=1.0,final_beta=2.0,anneal_steps=4")

    def four(captured):
        loop = _cli_stack_loop(cuda, stack)
        state = loop.init(seed=3)
        if captured:
            graph = loop.capture(state)
            m, b = graph.warmup
            rows = [(m["loss"].clone(), b.actions.clone())]
            for _ in range(3):    # a copy: the next replay overwrites them
                m, b = graph()
                rows.append((m["loss"].clone(), b.actions.clone()))
        else:
            rows = [(m["loss"].clone(), b.actions.clone()) for m, b in
                    (loop.step(state)[1:] for _ in range(4))]
        torch.cuda.synchronize()
        return loop, rows, {k: v.detach().clone() for k, v in
                            loop.policy.params.flat().items()}

    loop, eager, pa = four(False)
    _, capt, pc = four(True)
    for (la, aa), (lc, ac) in zip(eager, capt):
        assert torch.equal(lc, la) and torch.equal(ac, aa)
    for k in pa:
        assert torch.equal(pc[k], pa[k]), k
    betas = [float(loop.env.update_params(
        loop.env_params, torch.tensor(i, device=cuda)).extra["beta"])
        for i in range(5)]
    assert betas == [1.0, 1.25, 1.5, 1.75, 2.0]


def test_resume_on_cuda_is_bitwise_the_uninterrupted_run(cuda, tmp_path):
    """tfbind8_tb with the backward-replay sampler, the clip and decay:
    six captured iterations against three, a checkpoint, and a restore
    into a fresh loop for three more (its own capture): every leaf of the
    state (params, Adam's moments and step, the counter, the buffer)
    bitwise."""
    from repro_torch.algo import make_sampler
    from repro_torch.checkpoint import CheckpointManager

    def loop():
        return _cli_stack_loop(cuda, (), make_sampler("backward_replay",
                                                      capacity=64))

    a = loop()
    sa, _ = a.run(3, 6)
    mgr = CheckpointManager(tmp_path)
    b = loop()
    b.run(3, 3, checkpoint=mgr, checkpoint_every=3)
    c = loop()
    sc, _ = c.run(3, 6, checkpoint=mgr, restore=True)
    assert c.captured.replays == 2
    want, have = a.checkpoint_tree(sa), c.checkpoint_tree(sc)
    assert set(want) == set(have) and ".sampler/.size" in want
    for k in want:
        assert torch.equal(want[k], have[k]), k


def test_box_quadrature_eval_on_cuda_matches_cpu(cuda):
    """The recipe's eval on the card: its target equal to the CPU's to
    1e-6, the same bins as the CPU's for the card's terminals, finite
    metrics in range, the same metrics at the same seed."""
    rec = recipes.get_train("box_tb")
    env = rec.make_env()
    evs = {}
    for dev in (cuda, torch.device("cpu")):
        policy = rec.make_policy(env, seed=0, device=dev)
        evs[dev.type], = rec.make_evals(env, env.init(dev), policy,
                                        eval_batch=64)
    g, c = evs["cuda"], evs["cpu"]
    torch.testing.assert_close(g.target.cpu(), c.target, rtol=1e-6,
                               atol=1e-9)
    out = g(7)
    assert 0 < float(out["quad_tv"]) <= 1 and float(out["quad_jsd"]) > 0
    assert torch.equal(g(7)["quad_tv"], out["quad_tv"])
    pos = torch.rand(4096, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(g.flat_index(pos.to(cuda)).cpu(), c.flat_index(pos))


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
    """A differentiated call with a q_offset or a kv_len short of Skv (only
    cached decode passes those) raises; strided and misaligned operands
    are refused."""
    q, k, v = (torch.randn(s, device=cuda) for s in
               ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
    for kw in (dict(q_offset=3), dict(kv_len=5)):
        with pytest.raises(NotImplementedError, match="no gradient"):
            ops.flash_attention(q.clone().requires_grad_(True), k, v, **kw)
    with torch.no_grad():
        ops.flash_attention(q.clone().requires_grad_(True), k, v, kv_len=5)
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
    """The backward kernel takes Dv <= 64: a differentiated call past it
    raises before the forward runs; the same call without grad runs."""
    r = torch.randn(1, 4, 2, 16, device=cuda)
    w = torch.full_like(r, 0.5)
    v = torch.randn(1, 4, 2, 80, device=cuda)
    before = ops.rwkv6_scan.launches
    with pytest.raises(ValueError, match="Dv <= 64"):
        ops.rwkv6_scan(r.clone().requires_grad_(True), r, v, w)
    assert ops.rwkv6_scan.launches == before
    with torch.no_grad():
        ops.rwkv6_scan(r.clone().requires_grad_(True), r, v, w)


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
    recurrence; the chunk route differentiates (one forward, one backward
    launch), refuses strided operands, and leaves the state it is given
    as it was."""
    assert ops.scan_route(torch.bfloat16, 64) == "chunk"
    assert ops.scan_route(torch.bfloat16, 4096) == "chunk"
    assert ops.scan_route(torch.bfloat16, 1) == "recurrence"
    assert ops.scan_route(torch.float32, 4096) == "recurrence"
    r, k, v, w, u, s0 = _scan_inputs(1, 128, 2, 16, 64, True, True, "mild",
                                     cuda, seed=0)
    before = (ops.rwkv6_scan.route_launches["chunk"],
              ops.rwkv6_scan_backward.launches)
    rg = r.float().requires_grad_(True)
    o, _ = ops.rwkv6_scan(rg.to(torch.bfloat16), k, v, w)
    o.float().sum().backward()
    assert (ops.rwkv6_scan.route_launches["chunk"],
            ops.rwkv6_scan_backward.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert rg.grad is not None and bool(torch.isfinite(rg.grad).all())
    with pytest.raises(ValueError, match="v must be contiguous"):
        ops.rwkv6_scan(r, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                       w)
    want = ops.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    o, state_out = ops.rwkv6_scan(r, k, v, w, u, state)
    assert torch.equal(o, want[0]) and torch.equal(state_out, want[1])
    assert torch.equal(state, s0)


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, D, causal, window, bf16)
    (2, 128, 128, 4, 2, 64, True, 0, False),
    (1, 100, 100, 8, 8, 32, True, 0, False),
    (2, 64, 256, 4, 1, 128, False, 0, False),       # cross, D 128
    (1, 256, 256, 4, 2, 64, True, 64, False),       # window
    (1, 17, 33, 2, 1, 16, False, 0, False),         # ragged
    (1, 70, 70, 3, 3, 24, True, 0, False),          # D 24
    (2, 300, 300, 25, 5, 64, True, 100, True),      # Hymba's heads, wgmma
    (2, 200, 200, 8, 2, 128, True, 0, True),        # dense D 128, wgmma
    (2, 45, 150, 4, 4, 64, False, 0, True),         # Whisper's cross
    (1, 64, 64, 2, 2, 24, True, 0, True),           # bf16, SIMT forward
    # the tensor-core backward (bf16, D % 16 == 0): Whisper's cross
    # lengths, ragged Sq, window edges at D 64 and 128, D 16 and 48
    (1, 448, 1500, 4, 4, 64, False, 0, True),
    (2, 100, 100, 5, 1, 64, True, 0, True),
    (1, 256, 256, 5, 1, 64, True, 64, True),
    (1, 300, 300, 4, 2, 128, True, 37, True),
    (1, 130, 130, 4, 4, 128, False, 0, True),
    (1, 64, 64, 2, 1, 16, True, 0, True),
    (1, 70, 90, 2, 1, 48, False, 0, True),
], ids=str)
def test_flash_attention_backward_matches_plain_version(cuda, case):
    """The backward kernel against ``ref_flash_attention_bwd`` on the same
    q, k, v, out, lse and cotangent (and, in fp32, against autograd of the
    dense plain version); the forward's lse against the plain one; one
    forward and one backward launch counted; a repeat is bitwise."""
    from repro_torch.kernels.ref import (ref_flash_attention_bwd,
                                         ref_flash_attention_lse)
    B, Sq, Skv, H, KVH, D, causal, window, bf16 = case
    g = torch.Generator().manual_seed(Sq + D)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do = (torch.randn(shape, generator=g).to(cuda, dt) for shape in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D), (B, Sq, H, D)))
    kw = dict(causal=causal, window=window)
    out, lse = ops._flash_forward(q, k, v, causal, window, 0, Skv, True)
    _close(lse, ref_flash_attention_lse(q, k, **kw), 1e-4)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention_backward.launches == before + 1
    want = ref_flash_attention_bwd(q, k, v, out, do, lse, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        if bf16:
            _close_bf16(a, b)
        else:
            _close(a, b, 1e-4)
    again = ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # through autograd: one forward and one backward launch
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    fwd = ops.flash_attention.launches
    bwd = ops.flash_attention_backward.launches
    o = ops.flash_attention(qg, kg, vg, **kw)
    torch.autograd.backward(o, do)
    assert (ops.flash_attention.launches, ops.flash_attention_backward.launches
            ) == (fwd + 1, bwd + 1)
    assert torch.equal(o.detach(), out)
    if not bf16:
        qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
        ref_out = ref_flash_attention(qr, kr, vr, **kw)
        dense = torch.autograd.grad(ref_out, (qr, kr, vr), do)
        for a, b in zip((qg.grad, kg.grad, vg.grad), dense):
            _close(a, b, 1e-4)


@pytest.mark.parametrize("case", [
    # (B, T, H, Dk, Dv, bonus, state, decay, route)
    (2, 64, 2, 16, 16, True, False, "mild", "recurrence"),
    (1, 100, 3, 32, 32, True, True, "mild", "recurrence"),
    (2, 130, 2, 16, 64, False, True, "strong", "recurrence"),
    (1, 77, 4, 64, 64, True, True, "mild", "recurrence"),   # RWKV6's heads
    (3, 33, 2, 8, 40, False, True, "strong", "recurrence"),  # odd sizes
    (2, 300, 25, 16, 64, False, True, "mild", "chunk"),     # Hymba's heads
    (2, 300, 25, 16, 64, False, False, "strong", "chunk"),
    (2, 200, 4, 64, 64, True, True, "mild", "chunk"),       # RWKV6's heads
    (2, 200, 4, 64, 64, True, True, "strong", "chunk"),
    (1, 1000, 5, 16, 64, True, True, "mild", "chunk"),      # ragged T
    # the chunk-parallel backward (bf16, T >= 64): one chunk, one step
    # past it, Hymba's ragged strong-decay row, rwkv6's 4,096 steps with u
    (2, 64, 3, 16, 64, False, True, "strong", "chunk"),
    (1, 65, 3, 64, 64, True, True, "strong", "chunk"),
    (2, 1000, 25, 16, 64, False, False, "strong", "chunk"),
    (1, 4096, 2, 64, 64, True, True, "mild", "chunk"),
    (2, 130, 3, 24, 40, True, True, "strong", "chunk"),     # odd Dk, Dv
], ids=str)
def test_rwkv6_scan_backward_matches_plain_version(cuda, case, monkeypatch):
    """The backward kernel against ``ref_rwkv6_bwd`` (the exact reverse
    recurrence) at mild and strong decays, from the chunk states either
    forward route keeps; bf16 on the chunk route, fp32 and bf16 on the
    recurrence; one backward launch; a repeat is bitwise."""
    from repro_torch.kernels.ref import ref_rwkv6_bwd
    B, T, H, Dk, Dv, bonus, state, decay, route = case
    r, k, v, w, u, s0 = _scan_inputs(B, T, H, Dk, Dv, bonus, state, decay,
                                     cuda, seed=T + Dk)
    if route == "recurrence" and T % 2:
        r, k, v = r.float(), k.float(), v.float()
    monkeypatch.setattr(ops, "scan_route", lambda dtype, steps: route)
    g = torch.Generator().manual_seed(7)
    do = torch.randn(B, T, H, Dv, generator=g).to(cuda, r.dtype)
    ds = torch.randn(B, H, Dk, Dv, generator=g).to(cuda)
    _, _, carry = ops._scan_forward(r, k, v, w, u, s0, True)
    before = ops.rwkv6_scan_backward.launches
    got = ops.rwkv6_scan_backward(r, k, v, w, u, s0, carry, do, ds)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan_backward.launches == before + 1
    want = ref_rwkv6_bwd(r, k, v, w, u, s0, do, ds)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            _close_bf16(a, b)
        else:
            _close(a, b, 1e-4)
    again = ops.rwkv6_scan_backward(r, k, v, w, u, s0, carry, do, ds)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_backward_row_with_no_key(cuda):
    """Causal with a window and Sq > Skv, on the tensor-core backward: rows
    55.. attend no key (lse = -inf); their dq is exactly 0 and the rest is
    held to the plain version."""
    from repro_torch.kernels.ref import ref_flash_attention_bwd
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    q, do = (torch.randn(1, 100, 2, 64, generator=g).to(cuda, bf)
             for _ in range(2))
    k, v = (torch.randn(1, 40, 1, 64, generator=g).to(cuda, bf)
            for _ in range(2))
    out, lse = ops._flash_forward(q, k, v, True, 16, 0, 40, True)
    assert bool(torch.isinf(lse[:, :, 55:]).all())
    got = ops.flash_attention_backward(q, k, v, out, do, lse, causal=True,
                                       window=16)
    assert float(got[0][:, 55:].float().abs().max()) == 0.0
    want = ref_flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                   window=16)
    for a, b in zip(got, want):
        _close_bf16(a, b)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 24, "simt"), (torch.float32, 64, "simt")])
def test_flash_attention_backward_takes_its_route(cuda, dtype, D, route):
    """``ops.flash_bwd_route`` picks the kernel by dtype and D alone: one
    call counts one launch on that route, none on the other, and a repeat
    is bitwise equal."""
    g = torch.Generator().manual_seed(D)
    q, do = (torch.randn(2, 150, 4, D, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 150, 2, D, generator=g).to(cuda, dtype)
            for _ in range(2))
    out, lse = ops._flash_forward(q, k, v, True, 0, 0, 150, True)
    before = dict(ops.flash_attention_backward.route_launches)
    got = ops.flash_attention_backward(q, k, v, out, do, lse)
    again = ops.flash_attention_backward(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    after = ops.flash_attention_backward.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: 2 * (r == route) for r in after}
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,T,route", [
    (torch.bfloat16, 64, "chunk"), (torch.bfloat16, 300, "chunk"),
    (torch.bfloat16, 63, "recurrence"), (torch.float32, 300, "recurrence")])
def test_rwkv6_scan_backward_takes_its_route(cuda, dtype, T, route):
    """``ops.scan_bwd_route`` picks the kernel by dtype and T alone: one
    call counts one launch on that route, none on the other, and a repeat
    is bitwise equal (strong decays, u, a state)."""
    r, k, v, w, u, s0 = _scan_inputs(2, T, 3, 64, 64, True, True, "strong",
                                     cuda, seed=T)
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    g = torch.Generator().manual_seed(3)
    do = torch.randn(2, T, 3, 64, generator=g).to(cuda, dtype)
    ds = torch.randn(2, 3, 64, 64, generator=g).to(cuda)
    _, _, carry = ops._scan_forward(r, k, v, w, u, s0, True)
    before = dict(ops.rwkv6_scan_backward.route_launches)
    got = ops.rwkv6_scan_backward(r, k, v, w, u, s0, carry, do, ds)
    again = ops.rwkv6_scan_backward(r, k, v, w, u, s0, carry, do, ds)
    torch.cuda.synchronize()
    after = ops.rwkv6_scan_backward.route_launches
    assert {x: after[x] - before[x] for x in after} == {
        x: 2 * (x == route) for x in after}
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rwkv6_scan_backward_through_the_clip_on_cuda(cuda):
    """dw at w = 1 and w = 1e-8 exactly is half the unclipped gradient
    (JAX's jnp.clip), 0 past the bounds; autograd reaches every operand."""
    from repro_torch.kernels.ref import ref_rwkv6_bwd
    r, k, v, w, u, s0 = _scan_inputs(1, 70, 2, 16, 64, True, True, "mild",
                                     cuda, seed=3)
    r, k, v = r.float(), k.float(), v.float()
    w = w.clone()
    w[0, ::4] = 1.0
    w[0, 1::4] = 1e-8
    w[0, 2::8] = 1.5
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s0)]
    o, S = ops.rwkv6_scan(*ins)
    g = torch.Generator().manual_seed(1)
    do = torch.randn(o.shape, generator=g).to(cuda)
    (o * do).sum().add_(S.sum()).backward()
    want = ref_rwkv6_bwd(r, k, v, w, u, s0, do, torch.ones_like(S))
    for x, b in zip(ins, want):
        _close(x.grad, b, 1e-4)
    assert float(ins[3].grad[0, 2::8].abs().max()) == 0.0


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


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "command-r-35b",
                                  "rwkv6-1.6b"])
def test_lm_family_smoke_on_cuda_matches_the_cpu(cuda, monkeypatch, arch):
    """The dense and RWKV6 smoke configs in fp32, the same parameters on
    both devices: a 20-token scoring pass (dense: one flash launch a
    layer; rwkv: one scan launch a layer) and 10 decode steps (dense:
    ``_decode_attention`` in plain torch, no launch; rwkv: one scan launch
    a layer and step) equal the CPU's plain versions, the cache and states
    after them too; the dense models also on an int8 cache."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rwkv = cfg.family == "rwkv"
    cpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    want = steps.make_prefill_step(cfg)({"model": cpu}, batch)
    configs = [cfg] if rwkv else [
        cfg, dataclasses.replace(cfg, kv_cache_dtype="int8")]
    caches = [LM.init_cache(c, 2, 16) for c in configs]
    want_logits = [[LM.decode_step(cpu, c, toks[:, t:t + 1], cache)[0]
                    for t in range(10)] for c, cache in zip(configs, caches)]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(ops, "ref_flash_attention", refuse)
    monkeypatch.setattr(ops, "ref_rwkv6", refuse)
    f0, s0 = ops.flash_attention.launches, ops.rwkv6_scan.launches
    got = steps.make_prefill_step(cfg)(
        {"model": gpu}, {k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - f0,
            ops.rwkv6_scan.launches - s0) == ((0, 2) if rwkv else (2, 0))
    _close(got.cpu(), want, 1e-4)
    for c, cache_c, logits_c in zip(configs, caches, want_logits):
        cache_g = LM.init_cache(c, 2, 16, device=cuda)
        f0, s0 = ops.flash_attention.launches, ops.rwkv6_scan.launches
        with torch.no_grad():
            for t in range(10):
                logits, cache_g = LM.decode_step(gpu, c,
                                                 toks[:, t:t + 1].to(cuda),
                                                 cache_g)
                _close(logits.cpu(), logits_c[t], 1e-4)
        torch.cuda.synchronize()
        assert (ops.flash_attention.launches - f0,
                ops.rwkv6_scan.launches - s0) == ((0, 20) if rwkv else (0, 0))
        if rwkv:
            for name in ("shift", "cm_shift", "wkv"):
                _close(cache_g[name].cpu(), cache_c[name], 1e-4)
            continue
        assert torch.equal(cache_g["kv"]["pos"].cpu(), cache_c["kv"]["pos"])
        for name, t in cache_c["kv"].items():
            if t.dtype == torch.int8:
                off = (cache_g["kv"][name].cpu().int() - t.int()).abs()
                assert int(off.max()) <= 1, name
            else:
                _close(cache_g["kv"][name].cpu(), t, 1e-4)


def _family_inputs(cfg, S, device, seed=1):
    """A scoring batch of S positions and per-step decode inputs for the
    VLM (embeddings and (3, B, S) position ids: 2 text tokens, a 2 x 3
    grid, text from 5) and Whisper (12 frames) as for the rest (tokens)."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        t = [0, 1] + [2] * 6 + list(range(5, S - 3))
        h = [0, 1, 2, 2, 2, 3, 3, 3] + list(range(5, S - 3))
        w = [0, 1, 2, 3, 4, 2, 3, 4] + list(range(5, S - 3))
        pos = torch.tensor([t, h, w])[:, None].expand(3, 2, S).contiguous()
        batch = {"embeds": torch.randn(2, S, cfg.d_model, generator=g),
                 "position_ids": pos, "targets": batch["targets"]}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 12, cfg.d_model, generator=g)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-30b-a3b", "whisper-medium"])
def test_new_lm_family_smoke_on_cuda_matches_the_cpu(cuda, monkeypatch,
                                                     arch):
    """The VLM, MoE and Whisper smoke configs in fp32, the same parameters
    on both devices: a 16-position scoring pass (one flash launch a layer;
    Whisper three: encoder, decoder self- and cross-attention) and 6
    decode steps (no launch; Whisper one cross-attention launch a layer
    and step, with Sq = 1) equal the CPU's plain versions; the MoE's
    routing of the pass's first layer equal; the cache after them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm as LM
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    L = cfg.num_layers
    cpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=cuda)
    bc, bg = (_family_inputs(cfg, 16, d) for d in ("cpu", cuda))
    want = steps.make_prefill_step(cfg)({"model": cpu}, bc)

    def decode(params, batch, device):
        cache = LM.init_cache(cfg, 2, 8, device=device)
        if cfg.family == "encdec":
            cache["cross"] = LM.build_cross_cache(params, cfg,
                                                  batch["frames"])
        out = []
        with torch.no_grad():
            for t in range(6):
                kw = ({"embeds": batch["embeds"][:, t:t + 1],
                       "position_ids": batch["position_ids"][:, :, t:t + 1]}
                      if cfg.family == "vlm" else {})
                tok = batch["targets"][:, t:t + 1]
                out.append(LM.decode_step(params, cfg, tok, cache, **kw)[0])
        return out, cache

    want_logits, cache_c = decode(cpu, bc, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(ops, "ref_flash_attention", refuse)
    f0 = ops.flash_attention.launches
    got = steps.make_prefill_step(cfg)({"model": gpu}, bg)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches - f0 == \
        (3 * L if cfg.family == "encdec" else L)
    _close(got.cpu(), want, 1e-4)
    f0 = ops.flash_attention.launches
    logits, cache_g = decode(gpu, bg, cuda)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches - f0 == \
        (L + 6 * L if cfg.family == "encdec" else 0)
    for t in range(6):
        _close(logits[t].cpu(), want_logits[t], 1e-4)
    assert torch.equal(cache_g["kv"]["pos"].cpu(), cache_c["kv"]["pos"])
    for name in ("k", "v"):
        _close(cache_g["kv"][name].cpu(), cache_c["kv"][name], 1e-4)
    if cfg.family == "moe":
        x = torch.randn(32, cfg.d_model, generator=torch.Generator()
                        .manual_seed(2))
        rc = moe.moe_route(LM._layer(cpu["layers"], 0), x, cfg, 8)
        rg = moe.moe_route(LM._layer(gpu["layers"], 0), x.to(cuda), cfg, 8)
        for name in ("experts", "position", "keep"):
            assert torch.equal(rg[name].cpu(), rc[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_cached_call_on_cuda_matches_the_cpu(cuda, monkeypatch, dtype):
    """The cached S > 1 branch of ``attention_sublayer`` (qwen2.5-32b's
    smoke layer): 8 new tokens onto a 64-slot cache holding 40 reach the
    flash kernel with ``q_offset`` 40 and ``kv_len`` 48 (fp32 on the SIMT
    route, bf16 on the tensor cores); the attention itself held against
    the CPU's plain version, the stored positions exactly."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as model_layers
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                              dtype=dtype)
    dt = LM._dtype(cfg)
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    p = LM._layer(params["layers"], 0)["attn"]
    g = torch.Generator().manual_seed(1)
    cache = LM.init_cache(cfg, 2, 64)
    layer = {k: t[0] for k, t in cache["kv"].items()}
    layer["k"][:, :40] = torch.randn(2, 40, 2, 16, generator=g).to(dt)
    layer["v"][:, :40] = torch.randn(2, 40, 2, 16, generator=g).to(dt)
    layer["pos"][:, :40] = torch.arange(40, dtype=torch.int32)
    x = torch.randn(2, 8, cfg.d_model, generator=g).to(dt)
    pos = torch.arange(40, 48)[None].expand(2, 8)
    seen = []

    class RecordingOps:
        """``ops`` as the model's layers see it, recording flash's
        arguments before the wrapper runs (and counts) as it would."""

        def __getattr__(self, name):
            return getattr(ops, name)

        @staticmethod
        def flash_attention(q, k, v, **kw):
            seen.append(kw)
            return ops.flash_attention(q, k, v, **kw)

    want_c = {k: t.clone() for k, t in layer.items()}
    want, _ = LM.attention_sublayer(p, x, cfg, pos, cache=want_c,
                                    cache_index=40)
    layer_g = {k: t.to(cuda) for k, t in layer.items()}
    p_g = {k: t.to(cuda) for k, t in p.items()}
    monkeypatch.setattr(model_layers, "ops", RecordingOps())
    routes = dict(ops.flash_attention.route_launches)
    got, _ = LM.attention_sublayer(p_g, x.to(cuda), cfg, pos.to(cuda),
                                   cache=layer_g, cache_index=40)
    torch.cuda.synchronize()
    assert seen == [dict(causal=True, window=0, q_offset=40, kv_len=48)]
    route = ops.flash_route(dt, 16)
    assert ops.flash_attention.route_launches[route] == routes[route] + 1
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert torch.equal(layer_g["pos"].cpu(), want_c["pos"])
    for name in ("k", "v"):
        _close(layer_g[name].cpu(), want_c[name], tol)
    _close(got.cpu(), want, tol)
