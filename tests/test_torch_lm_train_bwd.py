"""The plain versions of the two backward kernels against JAX's autodiff
of its jnp layers (what the JAX package differentiates when it trains):
``ref_flash_attention_bwd`` (and ``ops.flash_attention``'s gradient on
the CPU) against ``jax.vjp`` of ``repro.models.layers.flash_attention``
-- causal, windowed, GQA, Whisper-style cross-attention with Sq != Skv --
and ``ref_rwkv6_bwd`` (and ``ops.rwkv6_scan``'s gradient) against
``jax.vjp`` of ``chunked_linear_attention`` with u and an initial state,
at decays >= 0.35 (below, JAX's chunk form departs from the recurrence:
``ROADMAP.md`` queue 3, reference item 4).  Both also against torch's
autograd of the dense / step-recurrence forward.  Through the clip,
w = 1 and w = 1e-8 exactly get JAX's 1/2 (torch's clamp would give 1).
Float32 throughout, 1e-4 of each gradient's largest entry: the same math
summed in other orders.  Inputs from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (ref_flash_attention,  # noqa: E402
                                     ref_flash_attention_bwd,
                                     ref_flash_attention_lse, ref_rwkv6,
                                     ref_rwkv6_bwd)

torch.set_num_threads(2)


def _close(got, want, tol=1e-4, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-6), (name, err, scale)


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, D, causal, window)
    (2, 24, 24, 4, 2, 8, True, 0),
    (1, 40, 40, 6, 2, 16, True, 7),       # Hymba's windowed GQA
    (2, 33, 33, 5, 1, 8, True, 0),        # ragged chunks of the jnp layer
    (2, 12, 30, 4, 4, 16, False, 0),      # Whisper's cross-attention
])
def test_flash_attention_backward_matches_jax_vjp(case):
    B, Sq, Skv, H, KVH, D, causal, window = case
    rng = np.random.RandomState(Sq + D)
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D), (B, Sq, H, D)))
    fn = jax.jit(lambda q, k, v: JL.flash_attention(
        q, k, v, causal=causal, window=window, chunk=16))
    out, vjp = jax.vjp(fn, q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window)
    tout = ref_flash_attention(tq, tk, tv, **kw)
    _close(tout, out, name="out")
    lse = ref_flash_attention_lse(tq, tk, **kw)
    got = ref_flash_attention_bwd(tq, tk, tv, tout, tdo, lse, **kw)
    for g, w, n in zip(got, want, "qkv"):
        _close(g, w, name=f"plain d{n}")
    # the wrapper's gradient, and autograd of the dense forward
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    torch.autograd.backward(ops.flash_attention(qg, kg, vg, **kw), tdo)
    qa, ka, va = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    dense = torch.autograd.grad(ref_flash_attention(qa, ka, va, **kw),
                                (qa, ka, va), tdo)
    for g, w, d, n in zip((qg.grad, kg.grad, vg.grad), want, dense, "qkv"):
        _close(g, w, name=f"wrapper d{n}")
        _close(g, d.numpy(), name=f"autograd d{n}")


def test_flash_attention_grad_refuses_cached_decode_operands():
    q, k, v = (torch.randn(s) for s in ((1, 4, 2, 8), (1, 9, 1, 8),
                                        (1, 9, 1, 8)))
    for kw in (dict(q_offset=5), dict(kv_len=7)):
        with pytest.raises(NotImplementedError, match="no gradient"):
            ops.flash_attention(q.requires_grad_(True), k, v, **kw)


def _scan_inputs(B, T, H, Dk, Dv, seed, state=True, bonus=True):
    rng = np.random.RandomState(seed)
    r, k = (rng.randn(B, T, H, Dk).astype(np.float32) for _ in range(2))
    v = rng.randn(B, T, H, Dv).astype(np.float32)
    w = (0.35 + 0.6 / (1 + np.exp(-rng.randn(B, T, H, Dk)))).astype(
        np.float32)
    u = (0.1 * rng.randn(H, Dk)).astype(np.float32) if bonus else None
    s0 = rng.randn(B, H, Dk, Dv).astype(np.float32) if state else None
    do = rng.randn(B, T, H, Dv).astype(np.float32)
    ds = rng.randn(B, H, Dk, Dv).astype(np.float32)
    return r, k, v, w, u, s0, do, ds


def _jax_scan_vjp(r, k, v, w, u, s0, do, ds, chunk):
    args = [x for x in (r, k, v, w, u, s0) if x is not None]
    has_u, has_s = u is not None, s0 is not None

    def fn(*a):
        a = list(a)
        r, k, v, w = a[:4]
        uu = a[4] if has_u else None
        ss = a[-1] if has_s else None
        return JL.chunked_linear_attention(r, k, v, w, uu, state=ss,
                                           chunk=chunk)

    out, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, args))
    return out, vjp((jnp.asarray(do), jnp.asarray(ds)))


@pytest.mark.parametrize("case", [
    # (B, T, H, Dk, Dv, state, bonus)
    (2, 20, 2, 8, 8, True, True),         # RWKV6's form: u, a state
    (1, 70, 3, 4, 16, True, False),       # Hymba's SSM: Dk != Dv, no u
    (2, 9, 2, 16, 16, False, True),       # no state
])
def test_rwkv6_backward_matches_jax_vjp(case):
    B, T, H, Dk, Dv, state, bonus = case
    r, k, v, w, u, s0, do, ds = _scan_inputs(B, T, H, Dk, Dv, seed=T,
                                             state=state, bonus=bonus)
    (o, S), want = _jax_scan_vjp(r, k, v, w, u, s0, do, ds, chunk=16)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = ref_rwkv6_bwd(t(r), t(k), t(v), t(w), t(u), t(s0), t(do), t(ds))
    names = ["r", "k", "v", "w"] + (["u"] if bonus else []) \
        + (["state"] if state else [])
    got = [g for g, n in zip(got, ["r", "k", "v", "w", "u", "state"])
           if n in names]
    for g, w_, n in zip(got, want, names):
        _close(g, w_, name=f"plain d{n}")
    # the wrapper's gradient and autograd of the step recurrence
    ins = [t(x).requires_grad_(True) for x in (r, k, v, w, u, s0)
           if x is not None]
    a = dict(zip(names, ins))
    out, st = ops.rwkv6_scan(a["r"], a["k"], a["v"], a["w"], a.get("u"),
                             a.get("state"))
    _close(out, o, name="out")
    _close(st, S, name="state")
    grads = torch.autograd.grad((out * t(do)).sum() + (st * t(ds)).sum(),
                                ins)
    ins2 = [x.detach().clone().requires_grad_(True) for x in ins]
    a2 = dict(zip(names, ins2))
    o2, s2 = ref_rwkv6(a2["r"], a2["k"], a2["v"], a2["w"], a2.get("u"),
                       a2.get("state"))
    plain = torch.autograd.grad((o2 * t(do)).sum() + (s2 * t(ds)).sum(),
                                ins2)
    for g, w_, p, n in zip(grads, want, plain, names):
        _close(g, w_, name=f"wrapper d{n}")
        _close(g, p.numpy(), name=f"autograd d{n}")


def test_rwkv6_gradient_through_the_clip_bound_matches_jax():
    """w exactly on the upper bound of the clip: JAX's jnp.clip passes
    half the gradient there, and so does the port (torch's clamp would
    pass all of it); past the bound none."""
    r, k, v, w, u, s0, do, ds = _scan_inputs(1, 4, 2, 4, 4, seed=5)
    w = w.copy()
    w[0, 1, 0] = 1.0
    w[0, 2, 1, :2] = 2.0
    (_, _), want = _jax_scan_vjp(r, k, v, w, u, s0, do, ds, chunk=4)
    t = torch.from_numpy
    got = ref_rwkv6_bwd(t(r), t(k), t(v), t(w), t(u), t(s0), t(do), t(ds))
    _close(got[3], want[3], name="dw")
    assert float(np.abs(np.asarray(want[3])[0, 2, 1, :2]).max()) == 0.0
    assert float(got[3][0, 2, 1, :2].abs().max()) == 0.0
    wt = t(w).requires_grad_(True)
    o, S = ref_rwkv6(t(r), t(k), t(v), wt, t(u), t(s0))
    (g,) = torch.autograd.grad((o * t(do)).sum() + (S * t(ds)).sum(), wt)
    torch.testing.assert_close(g[0, 1, 0], 2 * got[3][0, 1, 0])


def test_clip_derivative_is_jax_at_both_bounds():
    """``ref.clip_grad`` is JAX's derivative of ``jnp.clip(w, 1e-8, 1)``
    at every w, 1/2 on both bounds.  (At w = 1e-8 JAX's whole scan
    gradient is its chunk form's log-space derivative times 1/w = 1e8,
    which amplifies that form's rounding past use: reference item 4.  The
    port's is the exact recurrence's, ``rowsum(S_{t-1} G_t) / 2``.)"""
    from repro_torch.kernels.ref import clip_grad
    ws = np.array([0.0, 1e-9, 1e-8, 2e-8, 0.5, 1.0, 1.5], np.float32)
    want = jax.vmap(jax.grad(lambda x: jnp.clip(x, 1e-8, 1.0)))(
        jnp.asarray(ws))
    np.testing.assert_array_equal(clip_grad(torch.from_numpy(ws)).numpy(),
                                  np.asarray(want))
    r, k, v, w, u, s0, do, ds = _scan_inputs(1, 4, 2, 4, 4, seed=5)
    w = w.copy()
    w[0, 1, 0] = 1e-8
    t = torch.from_numpy
    got = ref_rwkv6_bwd(t(r), t(k), t(v), t(w), t(u), t(s0), t(do), t(ds))
    wt = t(w).requires_grad_(True)
    o, S = ref_rwkv6(t(r), t(k), t(v), wt, t(u), t(s0))
    (g,) = torch.autograd.grad((o * t(do)).sum() + (S * t(ds)).sum(), wt)
    torch.testing.assert_close(g[0, 1, 0], 2 * got[3][0, 1, 0])
