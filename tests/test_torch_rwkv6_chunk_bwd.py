"""The arithmetic of the chunk-parallel RWKV6 scan backward, emulated on the CPU.

``rwkv6_chunk_bwd.cu`` (the ``"chunk"`` route of ``ops.scan_bwd_route``)
cuts the sequence into the forward's chunks of 64 steps and runs four
passes: each chunk's own contribution to the adjoint entering it,
sum_s (r_s 2^{L_s})^T dO_s on the tensor cores as the forward's state pass
forms a chunk's own state (the decayed r in two bf16 parts, dO whole;
every exponent <= 0), and the chunk's decay 2^{L_C}; a short reverse pass
over the chunks that carries the adjoint G from dS_T to each chunk's end
and to dS_0; then, for every chunk at once, the adjoint walked back from
its end (dk, dv, with the state rebuilt beside it for dw) and the state
walked forward from the forward's carry (dr), in fp32.  Nothing is ever
divided by w: dw_t = rowsum(S_{t-1} G_t) c'(w_t), with JAX's c' (1/2 on
the clip's bounds).  :func:`chunk_bwd` repeats those passes in plain torch
and is held entry by entry, under the check ``chip_smoke.py`` holds the
kernel to (``_held``: dr, dk, dv in bf16 to one bf16 ulp, |err| <= 2^-7
|want| + 1e-3 rms(want); dw, du, dS_0 in fp32 to 1e-4 |want| + 1e-4
rms(want)), against the plain version (``ref_rwkv6_bwd``, the exact
reverse recurrence) at strong decays (0.2, log-uniform down to the clip at
1e-8, and w exactly on both bounds) and against ``jax.vjp`` of JAX's chunk
form (``repro.models.layers.chunked_linear_attention``) at decays >= 0.35,
with u and an initial state.  The variant the kernel avoids, dw from the
chunk identity d log w = reverse cumsum(r dr - k dk) (+ the final state's
term) divided by w, fails the same check at strong decay.  Inputs are drawn
with numpy from a seed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import chunked_linear_attention as jax_layer  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import clip_grad, ref_rwkv6_bwd  # noqa: E402

torch.set_num_threads(2)

CHUNK = 64
F32 = torch.float32
#: (H, Dk, Dv, bonus): Hymba's SSM heads (25 cut to 3; state 16, head 64,
#: no u) and RWKV6's (64 x 64 with u, cut to 2 heads)
HYMBA = (3, 16, 64, False)
RWKV = (2, 64, 64, True)
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _product(a, b):
    """``a @ b`` as ``mma.sync`` takes it: the fp32 ``a`` as ``hi =
    bf16(a)`` and ``lo = bf16(a - hi)``, ``b`` bf16 already; products exact
    in fp32, sums in fp32."""
    hi = a.to(torch.bfloat16).to(F32)
    return hi @ b + (a - hi).to(torch.bfloat16).to(F32) @ b


def chunk_bwd(r, k, v, w, u, state, do, dstate, *, divide=False):
    """``(dr, dk, dv, dw, du, dstate)`` as ``rwkv6_chunk_bwd.cu`` computes
    them: r/k/v/do (B, T, H, Dk/Dv) bf16, w (B, T, H, Dk) fp32 unclipped,
    u (H, Dk) or None, state and dstate (B, H, Dk, Dv) fp32 or None.
    ``divide=True`` forms dw from the log-space chunk identity instead,
    divided by the clipped w."""
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    n = -(-T // CHUNK)
    pad = (0, 0, 0, 0, 0, n * CHUNK - T)
    pf = torch.nn.functional.pad

    def chunks(x, value=0.0):                 # (B, H, n, CHUNK, D)
        return pf(x.to(F32), pad, value=value).reshape(
            B, n, CHUNK, H, -1).permute(0, 3, 1, 2, 4)

    rc, kc, vc, gc = (chunks(x) for x in (r, k, v, do))
    wc = chunks(w.to(F32).clamp(1e-8, 1.0), value=1.0)
    uf = (torch.zeros(H, Dk) if u is None else u.to(F32))[None, :, None, :]
    vdo = (vc * gc).sum(-1)                                  # (B, H, n, C)
    ruk = (rc * uf[:, :, :, None] * kc).sum(-1)
    zeros = torch.zeros(B, H, Dk, Dv)

    # the forward's carry: the state entering each chunk
    S = zeros if state is None else state.to(F32)
    carry = []
    for c in range(n):
        carry.append(S)
        for t in range(CHUNK):
            S = wc[:, :, c, t, :, None] * S \
                + kc[:, :, c, t, :, None] * vc[:, :, c, t, None, :]
    carry = torch.stack(carry, 2)                        # (B, H, n, Dk, Dv)

    # 1. each chunk's own adjoint (from zero at its end) and its decay, as
    # the forward's state pass forms a chunk's own state: sum_s (r_s
    # 2^{L_s})^T dO_s on the tensor cores (the decayed r in two bf16
    # parts, dO whole), L_s the log2-cumsum of the clipped decays before
    # step s (every exponent <= 0); the decay 2^{L_C}
    L = torch.cat([torch.zeros_like(wc[..., :1, :]),
                   torch.log2(wc).cumsum(3)], 3)
    local = _product((rc * torch.exp2(L[..., :CHUNK, :])).transpose(-1, -2),
                     gc)
    decay = torch.exp2(L[..., CHUNK, :])
    # 2. the adjoint at each chunk's end, from dS_T
    G = zeros if dstate is None else dstate.to(F32)
    ends = [None] * n
    for c in reversed(range(n)):
        ends[c] = G
        G = decay[:, :, c, :, None] * G + local[:, :, c]
    dS0 = G
    G = torch.stack(ends, 2)

    # 4. the state forward from the carry (dr), every S_{t-1} kept (the
    # kernel keeps every 8th and rebuilds the rest by the same
    # operations); 3. and 4. the adjoint back from each chunk's end
    S, prev, dr = carry, [], []
    for t in range(CHUNK):
        prev.append(S)
        dr.append((S * gc[..., t, None, :]).sum(-1)
                  + uf * kc[..., t, :] * vdo[..., t, None])
        S = wc[..., t, :, None] * S + kc[..., t, :, None] * vc[..., t, None, :]
    dk, dv, dw = [None] * CHUNK, [None] * CHUNK, [None] * CHUNK
    for t in reversed(range(CHUNK)):
        dk[t] = (G * vc[..., t, None, :]).sum(-1) \
            + rc[..., t, :] * uf * vdo[..., t, None]
        dv[t] = (G * kc[..., t, :, None]).sum(-2) \
            + ruk[..., t, None] * gc[..., t, :]
        dw[t] = (prev[t] * G).sum(-1)
        G = wc[..., t, :, None] * G + rc[..., t, :, None] * gc[..., t, None, :]
    dr, dk, dv, dw = (torch.stack(x, 3) for x in (dr, dk, dv, dw))
    if divide:
        # w_t dL/dw_t = rowdot(dS_T, S_T) + sum_{s > t} (r_s dr'_s - k_s
        # dk'_s) - k_t dk'_t, with dr', dk' the gradients without the u
        # terms; then divided by w_t
        drp = dr - uf[..., None, :] * kc * vdo[..., None]
        dkp = dk - rc * uf[..., None, :] * vdo[..., None]
        flat = lambda x: x.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, Dk)
        x = flat(rc * drp - kc * dkp)
        tail = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1]) - x
        final = (0.0 if dstate is None
                 else (dstate.to(F32) * S[:, :, -1]).sum(-1)[:, None])
        a = final + tail - flat(kc * dkp)
        wfull = flat(wc)
        dw_t = (a / wfull)[:, :T]
    unflat = lambda x: x.permute(0, 2, 3, 1, 4).reshape(
        B, n * CHUNK, H, -1)[:, :T]
    dwt = (dw_t if divide else unflat(dw)) * clip_grad(w)
    du = None if u is None else \
        (rc * kc * vdo[..., None]).sum((0, 2, 3)).to(u.dtype)
    return (unflat(dr).to(r.dtype), unflat(dk).to(k.dtype),
            unflat(dv).to(v.dtype), dwt.to(w.dtype), du, dS0)


def _draw(B, T, H, Dk, Dv, seed, *, bonus, decay):
    """r, k, v, dO ~ N(0, 1) rounded to bf16; u ~ 0.1 N(0, 1); a state and
    dS_T ~ N(0, 1); w by ``decay``: "mild" 0.35 + 0.6 sigmoid(N(0, 1)),
    "0.2" constant, "strong" log-uniform in [1e-8, 0.3], "bounds" mild with
    every 5th entry exactly 1e-8 and every 7th exactly 1."""
    rng = np.random.RandomState(seed)
    r, k = (rng.randn(B, T, H, Dk).astype(np.float32) for _ in range(2))
    v, do = (rng.randn(B, T, H, Dv).astype(np.float32) for _ in range(2))
    if decay == "0.2":
        w = np.full((B, T, H, Dk), 0.2)
    elif decay == "strong":
        w = np.exp(rng.uniform(np.log(1e-8), np.log(0.3), (B, T, H, Dk)))
    else:
        w = 0.35 + 0.6 / (1 + np.exp(-rng.randn(B, T, H, Dk)))
    w = w.astype(np.float32)
    if decay == "bounds":
        w.reshape(-1)[::5] = np.float32(1e-8)
        w.reshape(-1)[::7] = 1.0
    u = (0.1 * rng.randn(H, Dk)).astype(np.float32) if bonus else None
    s, ds = (rng.randn(B, H, Dk, Dv).astype(np.float32) for _ in range(2))
    r, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).to(F32).numpy()
                   for x in (r, k, v, do))
    return r, k, v, w, u, s, do, ds


def _torch(r, k, v, w, u, s, do, ds):
    bf = torch.bfloat16
    t = lambda x: None if x is None else torch.from_numpy(x)
    return (t(r).to(bf), t(k).to(bf), t(v).to(bf), t(w), t(u), t(s),
            t(do).to(bf), t(ds))


def _excess(got, want):
    """Each gradient's excess: dr, dk, dv by the bf16 rule, the rest fp32."""
    held = _chip_smoke()._held
    return {n: held(a, b, n in ("dr", "dk", "dv"))["excess"]
            for n, a, b in zip(NAMES, got, want) if b is not None}


#: (geometry, B, T): one full chunk, one step past it, a ragged 200
SHAPES = [(HYMBA, 2, 64), (HYMBA, 1, 65), (HYMBA, 2, 200), (RWKV, 1, 64),
          (RWKV, 2, 65), (RWKV, 1, 200)]


@pytest.mark.parametrize("decay", ["0.2", "strong", "bounds"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_bwd_is_held_to_the_plain_version(shape, decay):
    (H, Dk, Dv, bonus), B, T = shape
    args = _torch(*_draw(B, T, H, Dk, Dv, seed=T + Dk, bonus=bonus,
                         decay=decay))
    got = chunk_bwd(*args)
    want = ref_rwkv6_bwd(*args)
    assert [None if g is None else g.dtype for g in got] == \
        [None if x is None else x.dtype for x in want]
    excess = _excess(got, want)
    assert max(excess.values()) <= 1, excess


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4]], ids=str)
def test_chunk_bwd_is_held_to_jax_vjp_at_mild_decay(shape):
    """Decays >= 0.35 (JAX's chunk form divides by the running product
    clamped at 1e-30, which 0.35^64 stays above), u and an initial state:
    JAX's autodiff of its chunk form on the same bf16 values in fp32."""
    (H, Dk, Dv, bonus), B, T = shape
    arrs = _draw(B, T, H, Dk, Dv, seed=T, bonus=True, decay="mild")
    r, k, v, w, u, s, do, ds = arrs

    def fn(r, k, v, w, u, s):
        return jax_layer(r, k, v, w, u, state=s, chunk=CHUNK)

    _, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, (r, k, v, w, u, s)))
    want = [torch.from_numpy(np.array(x))
            for x in vjp((jnp.asarray(do), jnp.asarray(ds)))]
    got = chunk_bwd(*_torch(*arrs))
    excess = _excess(got, want)
    assert max(excess.values()) <= 1, excess


@pytest.mark.parametrize("geometry", [HYMBA, RWKV], ids=["hymba", "rwkv"])
def test_dividing_by_w_fails_at_strong_decay(geometry):
    """dw from the chunk identity divided by w: at decays down to the clip
    the log-space sum is w times an O(1) gradient formed as a difference of
    O(1) terms, and the division multiplies its rounding by up to 1e8 (dw's
    excess 1.6e6 and 3.1e6 for the two geometries); the kernel's
    rowsum(S_{t-1} G_t) is held (0.11 and 0.65).  At mild decay the same
    division passes (0.06 and 0.10): the failure is the division's."""
    H, Dk, Dv, bonus = geometry
    args = _torch(*_draw(1, 130, H, Dk, Dv, seed=11, bonus=bonus,
                         decay="strong"))
    want = ref_rwkv6_bwd(*args)
    assert _excess(chunk_bwd(*args, divide=True), want)["dw"] > 100
    assert max(_excess(chunk_bwd(*args), want).values()) <= 1
    mild = _torch(*_draw(1, 130, H, Dk, Dv, seed=11, bonus=bonus,
                         decay="mild"))
    assert _excess(chunk_bwd(*mild, divide=True),
                   ref_rwkv6_bwd(*mild))["dw"] <= 1


@pytest.mark.parametrize("dtype,T,route", [
    (torch.bfloat16, 4096, "chunk"), (torch.bfloat16, 64, "chunk"),
    (torch.bfloat16, 63, "recurrence"), (torch.bfloat16, 1, "recurrence"),
    (torch.float32, 4096, "recurrence"), (torch.float32, 128, "recurrence")])
def test_route_rule(dtype, T, route):
    """``ops.scan_bwd_route``: the chunk-parallel backward for bf16 at T >=
    64 (the forward's chunk rule), the step recurrence for fp32 and short
    T; on CPU tensors neither runs, and no route counts a launch."""
    assert ops.scan_bwd_route(dtype, T) == route
    before = dict(ops.rwkv6_scan_backward.route_launches)
    r = torch.zeros(1, T, 2, 16, dtype=dtype, requires_grad=True)
    w = torch.ones(1, T, 2, 16)
    o, S = ops.rwkv6_scan(r, r, torch.zeros(1, T, 2, 8, dtype=dtype), w)
    (o.float().sum() + S.sum()).backward()
    assert r.grad is not None and r.grad.shape == r.shape
    assert ops.rwkv6_scan_backward.route_launches == before
