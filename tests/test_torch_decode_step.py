"""The port's fused decode step on the CPU: its plain version
(``repro_torch.kernels.ref.ref_decode_step``) against the JAX package's
oracle (``repro.kernels.ref.ref_decode_step``), and the wrapper
(``repro_torch.kernels.ops.decode_step``) on CPU tensors.

The JAX package's Pallas step does not run on this JAX version, so the
oracle is its plain reference, as in ``tests/test_fused_step.py``.  Inputs
are drawn with numpy from a seed and fed to both.  Tolerance 1e-5 (abs and
rel): both sides compute in fp32, in different reduction orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_decode_step as jax_ref_decode_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_decode_step  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, L, C, D, H, A):
    rng = np.random.RandomState(seed)
    F = 2 * D + 8
    f = lambda *s, scale=1.0: (scale * rng.randn(*s)).astype(np.float32)
    w = {"ln1_scale": 1 + f(L, D, scale=0.1), "ln1_bias": f(L, D, scale=0.1),
         "q_w": f(L, D, D, scale=D ** -0.5), "q_b": f(L, D, scale=0.1),
         "kv_w": f(L, D, 2 * D, scale=D ** -0.5),
         "kv_b": f(L, 2 * D, scale=0.1),
         "proj_w": f(L, D, D, scale=D ** -0.5), "proj_b": f(L, D, scale=0.1),
         "ln2_scale": 1 + f(L, D, scale=0.1), "ln2_bias": f(L, D, scale=0.1),
         "ff1_w": f(L, D, F, scale=D ** -0.5), "ff1_b": f(L, F, scale=0.1),
         "ff2_w": f(L, F, D, scale=F ** -0.5), "ff2_b": f(L, D, scale=0.1),
         "ln_f_scale": 1 + f(D, scale=0.1), "ln_f_bias": f(D, scale=0.1),
         "q0": f(D, scale=0.5)}
    lengths = rng.randint(0, C - 1, size=B).astype(np.int32)
    mask = rng.rand(B, A) < 0.6
    mask[:, 0] |= ~mask.any(-1)
    return dict(
        w=w, x_new=f(B, D, scale=0.5), k=f(L, B, C, D), v=f(L, B, C, D),
        lengths=lengths, slot=np.clip(lengths, 1, C - 1).astype(np.int32),
        gumbel=rng.gumbel(size=(B, A)).astype(np.float32), mask=mask,
        w_out=f(D, A, scale=D ** -0.5), b_out=f(A, scale=0.1),
        temp=(0.5 + rng.rand(B)).astype(np.float32))


def _torch(inp, slot, temp):
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()
         if k != "w"}
    w = {k: torch.from_numpy(v) for k, v in inp["w"].items()}
    return w, t, (torch.tensor(slot) if slot is not None else None), \
        (t["temp"] if temp else None)


@pytest.mark.parametrize("temp", [False, True], ids=["temp1", "tempered"])
@pytest.mark.parametrize("slot_kind", ["vector", "scalar"])
@pytest.mark.parametrize("D,H", [(16, 2), (64, 8)])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("C", [7, 9, 16])
def test_plain_step_matches_jax_oracle(C, L, D, H, slot_kind, temp):
    B, A = 5, 37
    inp = _inputs(1000 * C + 10 * L + D, B, L, C, D, H, A)
    slot = inp["slot"] if slot_kind == "vector" else np.int32(C // 2)
    ja = jax_ref_decode_step(
        {k: jnp.asarray(v) for k, v in inp["w"].items()},
        *(jnp.asarray(inp[k]) for k in ("x_new", "k", "v", "lengths")),
        jnp.asarray(slot), jnp.asarray(inp["gumbel"]),
        jnp.asarray(inp["mask"]), jnp.asarray(inp["w_out"]),
        jnp.asarray(inp["b_out"]),
        jnp.asarray(inp["temp"]) if temp else None, num_heads=H)
    w, t, slot_t, temp_t = _torch(inp, slot, temp)
    to = ref_decode_step(w, t["x_new"], t["k"], t["v"], t["lengths"],
                         slot_t, t["gumbel"], t["mask"], t["w_out"],
                         t["b_out"], temp_t, num_heads=H)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(ja[0]))
    assert to[0].dtype == torch.int32
    for name, a, b in zip(("log_pf", "y", "new_k", "new_v"), ja[1:], to[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)
    # the plain version is functional: its inputs are untouched
    np.testing.assert_array_equal(t["k"].numpy(), inp["k"])


def _wrapper_args(inp, H):
    w, t, _, _ = _torch(inp, None, False)
    L, B, C, D = inp["k"].shape
    cache = {"k": t["k"].view(L, B, C, H, D // H).clone(),
             "v": t["v"].view(L, B, C, H, D // H).clone()}
    return w, t, cache


def test_wrapper_on_cpu_runs_plain_version_in_place():
    H = 4
    inp = _inputs(7, 6, 2, 9, 32, H, 50)
    w, t, cache = _wrapper_args(inp, H)
    before = ops.decode_step.launches
    action, log_pf, y, out = ops.decode_step(
        w, t["x_new"], cache, t["lengths"], t["slot"], t["gumbel"],
        t["mask"], t["w_out"], t["b_out"], t["temp"], num_heads=H)
    assert ops.decode_step.launches == before
    assert out is cache
    ref = ref_decode_step(w, t["x_new"], t["k"], t["v"], t["lengths"],
                          t["slot"], t["gumbel"], t["mask"], t["w_out"],
                          t["b_out"], t["temp"], num_heads=H)
    assert torch.equal(action, ref[0])
    assert torch.equal(log_pf, ref[1]) and torch.equal(y, ref[2])
    L, B, C, D = inp["k"].shape
    assert torch.equal(cache["k"].view(L, B, C, D), ref[3])
    assert torch.equal(cache["v"].view(L, B, C, D), ref[4])


def test_wrapper_scalar_slot_matches_vector_slot():
    H = 2
    inp = _inputs(8, 4, 2, 7, 16, H, 21)
    outs = []
    for slot in (3, torch.full((4,), 3, dtype=torch.int32)):
        w, t, cache = _wrapper_args(inp, H)
        a, lp, y, cache = ops.decode_step(
            w, t["x_new"], cache, t["lengths"], slot, t["gumbel"], t["mask"],
            t["w_out"], t["b_out"], num_heads=H)
        outs.append((a, lp, y, cache["k"], cache["v"]))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad,error", [
    ("lengths_int64", TypeError), ("mask_float", TypeError),
    ("gumbel_noncontiguous", ValueError), ("gumbel_shape", ValueError),
    ("heads", ValueError), ("weight_dtype", TypeError)])
def test_wrapper_rejects_operands_the_kernel_does_not_take(bad, error):
    H = 2
    inp = _inputs(9, 3, 1, 7, 16, H, 12)
    w, t, cache = _wrapper_args(inp, H)
    lengths, mask, gumbel, heads = t["lengths"], t["mask"], t["gumbel"], H
    if bad == "lengths_int64":
        lengths = lengths.long()
    elif bad == "mask_float":
        mask = mask.float()
    elif bad == "gumbel_noncontiguous":
        gumbel = torch.cat([gumbel, gumbel], 1)[:, ::2]
    elif bad == "gumbel_shape":
        gumbel = gumbel[:, :-1].contiguous()
    elif bad == "heads":
        heads = 2 * H
    else:
        w = dict(w, q_w=w["q_w"].double())
    with pytest.raises(error):
        ops.decode_step(w, t["x_new"], cache, lengths, t["slot"], gumbel,
                        mask, t["w_out"], t["b_out"], num_heads=heads)
