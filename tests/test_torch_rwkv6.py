"""The port's RWKV6 scan against the JAX package's.

``repro_torch.kernels.ops.rwkv6_scan`` on CPU tensors runs its plain
version, the step recurrence ``repro_torch.kernels.ref.ref_rwkv6`` -- the
arithmetic of the recurrence kernel, and what both CUDA routes are held
against on the card (the chunk kernel's arithmetic is emulated in
``tests/test_torch_rwkv6_chunk.py``).  Here
it is held against the Pallas kernel in interpret mode and JAX's step
recurrence (``repro.kernels.ref.ref_rwkv6``) on the four ``RWKV_CASES`` of
``tests/test_kernels.py`` (tolerance 5e-4 fp32, 5e-2 bf16, the JAX
tests'), and against JAX's chunked model layer with a carried state.  The
port's copy of that chunk form (``chunked_linear_attention_ref``) is held
against JAX's and against the recurrence, with halves chained through the
state and at T = 1 (1e-4: fp32 on both sides, other orders); where a
chunk's decay product falls below the chunk form's 1e-30 clamp the two
forms part, and the port follows the exact recurrence.  Inputs are drawn
with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_rwkv6 as jax_ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas  # noqa: E402
from repro.models.layers import chunked_linear_attention as jax_layer  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (chunked_linear_attention_ref,  # noqa: E402
                                     ref_rwkv6)
from repro_torch.models import layers  # noqa: E402

torch.set_num_threads(2)

RWKV_CASES = [
    # (B, T, H, Dk, Dv, chunk, bonus, bf16, tol): tests/test_kernels.py
    (2, 64, 2, 16, 16, 16, True, False, 5e-4),
    (1, 100, 3, 32, 32, 32, True, False, 5e-4),
    (2, 128, 2, 16, 64, 64, False, False, 5e-4),
    (1, 48, 2, 16, 16, 16, True, True, 5e-2),
]
TOL = dict(atol=1e-4, rtol=1e-4)


def _draw(B, T, H, Dk, Dv, seed, bonus=True, state=False):
    """r, k, v ~ N(0, 1); w = 0.35 + 0.6 sigmoid(N(0, 1)) (the JAX
    tests' decays); u ~ 0.1 N(0, 1); a state ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, T, H, Dk).astype(np.float32)
    k = rng.randn(B, T, H, Dk).astype(np.float32)
    v = rng.randn(B, T, H, Dv).astype(np.float32)
    w = (0.35 + 0.6 / (1 + np.exp(-rng.randn(B, T, H, Dk)))).astype(
        np.float32)
    u = (0.1 * rng.randn(H, Dk)).astype(np.float32) if bonus else None
    s = rng.randn(B, H, Dk, Dv).astype(np.float32) if state else None
    return r, k, v, w, u, s


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", RWKV_CASES, ids=str)
def test_matches_pallas_and_jax_ref(case):
    B, T, H, Dk, Dv, chunk, bonus, bf16, tol = case
    r, k, v, w, u, _ = _draw(B, T, H, Dk, Dv, seed=T, bonus=bonus)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    o, S = ops.rwkv6_scan(*(_t(x, tdt) for x in (r, k, v, w, u)))
    assert o.dtype == tdt and S.dtype == torch.float32
    jargs = [_j(x, jdt) for x in (r, k, v, w, u)]
    o_p, S_p = rwkv6_scan_pallas(*jargs, chunk=chunk)
    o_r, S_r = jax_ref(*jargs)
    for want_o, want_S in ((o_p, S_p), (o_r, S_r)):
        np.testing.assert_allclose(_np(o), _np(want_o), atol=tol)
        np.testing.assert_allclose(_np(S), _np(want_S), atol=tol)


@pytest.mark.parametrize("T,chunk,bonus", [(40, 16, True), (37, 8, False),
                                           (1, 64, False)])
def test_carried_state_matches_the_jax_layer(T, chunk, bonus):
    """From a nonzero state, as the model calls it (decode: T = 1)."""
    r, k, v, w, u, s = _draw(2, T, 3, 16, 24, seed=T, bonus=bonus,
                             state=True)
    o, S = ops.rwkv6_scan(*(_t(x) for x in (r, k, v, w, u, s)))
    o_j, S_j = jax_layer(*(_j(x) for x in (r, k, v, w, u)), state=_j(s),
                         chunk=chunk)
    o_c, S_c = chunked_linear_attention_ref(*(_t(x) for x in (r, k, v, w, u,
                                                              s)),
                                            chunk=chunk)
    for got_o, got_S in ((o, S), (o_c, S_c)):
        np.testing.assert_allclose(_np(got_o), _np(o_j), **TOL)
        np.testing.assert_allclose(_np(got_S), _np(S_j), **TOL)
    o_r, S_r = jax_ref(*(_j(x) for x in (r, k, v, w, u)), state=_j(s))
    np.testing.assert_allclose(_np(o), _np(o_r), **TOL)
    np.testing.assert_allclose(_np(S), _np(S_r), **TOL)


@pytest.mark.parametrize("bonus", [True, False])
def test_recurrence_equals_its_chunk_form(bonus):
    r, k, v, w, u, s = _draw(2, 90, 2, 16, 64, seed=11, bonus=bonus,
                             state=True)
    args = [_t(x) for x in (r, k, v, w, u, s)]
    o, S = ref_rwkv6(*args)
    o_c, S_c = chunked_linear_attention_ref(*args, chunk=32)
    torch.testing.assert_close(o, o_c, **TOL)
    torch.testing.assert_close(S, S_c, **TOL)


@pytest.mark.parametrize("fn", [ref_rwkv6, chunked_linear_attention_ref],
                         ids=["recurrence", "chunk_form"])
def test_halves_chained_through_the_state_equal_the_whole(fn):
    r, k, v, w, u, s = _draw(1, 70, 2, 32, 32, seed=3, state=True)
    args = [_t(x) for x in (r, k, v, w, u)]
    o, S = fn(*args, _t(s))
    o1, S1 = fn(*(x[:, :33] for x in args[:4]), args[4], _t(s))
    o2, S2 = fn(*(x[:, 33:] for x in args[:4]), args[4], S1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o, **TOL)
    torch.testing.assert_close(S2, S, **TOL)


def test_one_step_from_a_state():
    """T = 1 (a decode step) from a nonzero state, against the formula."""
    r, k, v, w, u, s = _draw(3, 1, 2, 16, 64, seed=4, state=True)
    o, S = ops.rwkv6_scan(*(_t(x) for x in (r, k, v, w, u, s)))
    want_o = (np.einsum("bhd,bhde->bhe", r[:, 0], s)
              + np.sum(r[:, 0] * u * k[:, 0], -1)[..., None] * v[:, 0])
    want_S = w[:, 0][..., None] * s + k[:, 0][..., None] * v[:, 0][:, :, None]
    np.testing.assert_allclose(o.numpy()[:, 0], want_o, **TOL)
    np.testing.assert_allclose(S.numpy(), want_S, **TOL)


def test_decays_are_clipped_to_the_unit_interval():
    """w is clipped to [1e-8, 1] in the recurrence, as in the model's
    chunk form: w = 1.5 acts as 1 and w = 0 as 1e-8."""
    r, k, v, w, u, s = _draw(1, 20, 2, 16, 16, seed=6, state=True)
    w_out = w.copy()
    w_out[:, ::3] = 1.5
    w_out[:, 1::7] = 0.0
    w_in = np.clip(w_out, 1e-8, 1.0)
    got = ref_rwkv6(*(_t(x) for x in (r, k, v, w_out, u, s)))
    want = ref_rwkv6(*(_t(x) for x in (r, k, v, w_in, u, s)))
    chunk = chunked_linear_attention_ref(*(_t(x) for x in (r, k, v, w_out,
                                                           u, s)), chunk=8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, chunk):
        torch.testing.assert_close(a, b, **TOL)


def test_layer_runs_the_wrapper_and_refuses_grad():
    r, k, v, w, u, s = _draw(1, 9, 2, 16, 16, seed=7, state=True)
    args = [_t(x) for x in (r, k, v, w, u, s)]
    o, S = layers.chunked_linear_attention(*args)
    o2, S2 = ops.rwkv6_scan(*args)
    assert torch.equal(o, o2) and torch.equal(S, S2)
    # differentiable now; a call past the backward kernel's Dv <= 64
    # refuses grad on every device
    wide = _t(np.zeros((1, 9, 2, 80), np.float32))
    with pytest.raises(ValueError, match="no gradient"):
        ops.rwkv6_scan(args[0].clone().requires_grad_(), args[1], wide,
                       args[3])
    with torch.no_grad():
        ops.rwkv6_scan(args[0].clone().requires_grad_(), args[1], wide,
                       args[3])
    with pytest.raises(ValueError, match="state has shape"):
        ops.rwkv6_scan(*args[:5], args[5][:, :1])


def test_strong_decay_follows_the_exact_recurrence():
    """Decays of 0.2 multiply below 1e-30 within 43 steps of a 64-step
    chunk.  There JAX's chunk form (its model layer and the Pallas kernel)
    divides by the clamped product and parts from the recurrence; the port
    (``ops.rwkv6_scan``, the kernel's plain version) equals JAX's step
    recurrence, and the port's copy of the chunk form equals JAX's."""
    r, k, v, _, _, s = _draw(1, 128, 2, 16, 16, seed=8, bonus=False,
                             state=True)
    w = np.full(r.shape, 0.2, np.float32)
    args = [_t(x) for x in (r, k, v, w)]
    o, S = ops.rwkv6_scan(*args, None, _t(s))
    o_r, S_r = jax_ref(*(_j(x) for x in (r, k, v, w)), state=_j(s))
    np.testing.assert_allclose(_np(o), _np(o_r), **TOL)
    np.testing.assert_allclose(_np(S), _np(S_r), **TOL)
    o_c, S_c = chunked_linear_attention_ref(*args, None, _t(s), chunk=64)
    o_j, S_j = jax_layer(*(_j(x) for x in (r, k, v, w)), state=_j(s),
                         chunk=64)
    np.testing.assert_allclose(_np(o_c), _np(o_j), **TOL)
    np.testing.assert_allclose(_np(S_c), _np(S_j), **TOL)
    assert float((o_c - o).abs().max()) > 1.0     # the forms part here
