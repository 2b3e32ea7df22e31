"""The arithmetic of the tensor-core flash backward kernel, emulated on the CPU.

``flash_attention_bwd_wgmma.cu`` (the ``"wgmma"`` route of
``ops.flash_bwd_route``) runs FlashAttention-2's backward in two passes
over 64-row tiles: a dQ pass (one block per query tile: S = Q K^T and
dP = dO V^T over 64-key tiles, dQ += dS K) and a dK/dV pass (one block per
key tile: S^T = K Q^T and dP^T = V dO^T over every query head of the kv
head's group and every query tile, dV += P^T dO, dK += dS^T Q).  The
operands of S and dP are bf16 inputs, so those products are exact in
fp32; P = 2^(s scale log2(e) - lse log2(e)) and dS = P (dP - Delta) are
fp32 and go into their products as two bf16 parts, ``hi = bf16(x)`` and
``lo = bf16(x - hi)``, both products summed into one fp32 accumulator.
:func:`split_flash_bwd` repeats that arithmetic in plain torch: the same
tiles in the same order, bf16 operands, fp32 sums.  It is held entry by
entry to the plain version (``repro_torch.kernels.ref.
ref_flash_attention_bwd``) and to ``jax.vjp`` of JAX's jnp layer
(``repro.models.layers.flash_attention``) under the check ``chip_smoke.py``
holds the kernel to (``_held``: |err| <= 2^-7 |want| + 1e-3 rms(want),
excess <= 1, one bf16 ulp; against JAX the emulation takes the fp32
output, from which JAX's autodiff forms Delta).  The same emulation with P or dS rounded once
to bf16 fails that check: that is why the kernel splits both.  A row that
attends no key (lse = -inf) contributes nothing, as in the plain version
(JAX's layer averages every key there: that case is held to the plain
version only).  Inputs are drawn with numpy from a seed.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (attention_mask,  # noqa: E402
                                     ref_flash_attention,
                                     ref_flash_attention_bwd,
                                     ref_flash_attention_lse)

torch.set_num_threads(2)

F32 = torch.float32
LOG2E = 1.4426950408889634
BLOCK = 64

#: (B, Sq, Skv, H, KVH, D, causal, window): Hymba's head grouping (25/5
#: cut to 5/1) with its window, the dense configs' D 128 with GQA,
#: Whisper's cross-attention with ragged Sq and Skv, a short ragged causal
#: call
GEOMETRIES = [(1, 192, 192, 5, 1, 64, True, 96),
              (1, 160, 160, 4, 2, 128, True, 0),
              (2, 70, 150, 2, 2, 64, False, 0),
              (2, 100, 100, 2, 1, 32, True, 0)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(x):
    return x.to(torch.bfloat16).to(F32)


def _product(a, b, split):
    """``a @ b`` as the kernel's wgmma takes it: the fp32 ``a`` as
    ``bf16(a)`` and, with ``split``, ``bf16(a - bf16(a))`` (two register
    operands into one accumulator); ``b`` is bf16 already."""
    hi = _bf16(a)
    out = hi @ b
    if split:
        out = out + _bf16(a - hi) @ b
    return out


def split_flash_bwd(q, k, v, out, do, lse, *, causal, window, split_p=True,
                    split_ds=True):
    """``(dq, dk, dv)`` as the wgmma backward computes them, in q's dtype.
    q, out, do: (B, Sq, H, D); k/v: (B, Skv, KVH, D); lse (B, H, Sq) fp32.
    ``split_p`` / ``split_ds`` False round P / dS once to bf16 before its
    product."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf, dof, of = (x.to(F32).permute(0, 2, 1, 3) for x in (q, do, out))
    kf, vf = (x.to(F32).permute(0, 2, 1, 3) for x in (k, v))  # B KVH Skv D
    # the prep pass: Delta, and lse in log2 units (+inf where no key, so
    # that every P of the row is 2^-inf = 0)
    delta = (dof * of).sum(-1)                                 # B H Sq
    lse2 = torch.where(torch.isfinite(lse), lse * LOG2E, math.inf)
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=0,
                          kv_len=None, device=q.device).expand(Sq, Skv)
    c = LOG2E / math.sqrt(D)
    scale = 1.0 / math.sqrt(D)

    def scores(h, qs, ks):
        """P and dS of query rows ``qs`` of head h against keys ``ks``."""
        kvh = h // G
        s = qf[:, h, qs] @ kf[:, kvh, ks].transpose(-1, -2)
        dp = dof[:, h, qs] @ vf[:, kvh, ks].transpose(-1, -2)
        p = torch.exp2(s * c - lse2[:, h, qs, None])
        p = torch.where(mask[qs, ks], p, 0.0)
        return p, p * (dp - delta[:, h, qs, None])

    dq = torch.zeros(B, H, Sq, D)
    for h in range(H):
        for qt in range(0, Sq, BLOCK):
            qs = slice(qt, qt + BLOCK)
            for kt in range(0, Skv, BLOCK):
                ks = slice(kt, kt + BLOCK)
                _, ds = scores(h, qs, ks)
                dq[:, h, qs] += _product(ds, kf[:, h // G, ks], split_ds)
    dk = torch.zeros(B, KVH, Skv, D)
    dv = torch.zeros(B, KVH, Skv, D)
    for kvh in range(KVH):
        for kt in range(0, Skv, BLOCK):
            ks = slice(kt, kt + BLOCK)
            for h in range(kvh * G, (kvh + 1) * G):
                for qt in range(0, Sq, BLOCK):
                    qs = slice(qt, qt + BLOCK)
                    p, ds = scores(h, qs, ks)
                    dv[:, kvh, ks] += _product(p.transpose(-1, -2),
                                               dof[:, h, qs], split_p)
                    dk[:, kvh, ks] += _product(ds.transpose(-1, -2),
                                               qf[:, h, qs], split_ds)
    back = lambda x: x.permute(0, 2, 1, 3).to(q.dtype)
    return back(dq * scale), back(dk * scale), back(dv)


def _inputs(B, Sq, Skv, H, KVH, D, seed):
    """q, k, v, dO ~ N(0, 1) rounded to bf16 once (numpy, float32 values)."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32) for shape in (
        (B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D), (B, Sq, H, D))]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _forward(q, k, v, causal, window):
    """The forward's out (bf16) and lse, as the backward reads them."""
    kw = dict(causal=causal, window=window)
    return (ref_flash_attention(q, k, v, **kw),
            ref_flash_attention_lse(q, k, **kw))


def _excess(got, want):
    held = _chip_smoke()._held
    return max(held(a, b, True)["excess"] for a, b in zip(got, want))


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_split_bwd_is_held_to_the_plain_version_and_jax(geometry):
    B, Sq, Skv, H, KVH, D, causal, window = geometry
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, D, seed=Sq + D)
    out, lse = _forward(q, k, v, causal, window)
    kw = dict(causal=causal, window=window)
    got = split_flash_bwd(q, k, v, out, do, lse, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert _excess(got, ref_flash_attention_bwd(q, k, v, out, do, lse,
                                                **kw)) <= 1
    # JAX's autodiff of its jnp layer on the same bf16 values in fp32; its
    # Delta comes from the fp32 output, so the emulation's does here too
    # (from the bf16 out, dq and dk part from JAX's by ~10 ulps where dP
    # and Delta cancel, the plain version's as much: a property of the
    # rounded out, not of the kernel's arithmetic)
    fn = jax.jit(lambda q, k, v: JL.flash_attention(
        q, k, v, causal=causal, window=window, chunk=BLOCK))
    f = lambda x: jnp.asarray(x.to(F32).numpy())
    _, vjp = jax.vjp(fn, f(q), f(k), f(v))
    want = [torch.from_numpy(np.asarray(g)) for g in vjp(f(do))]
    out32 = ref_flash_attention(q.to(F32), k.to(F32), v.to(F32), **kw)
    assert _excess(split_flash_bwd(q, k, v, out32, do, lse, **kw),
                   want) <= 1


def test_row_with_no_key_contributes_nothing():
    """Causal with a window and Sq > Skv: rows 55.. attend no key (lse =
    -inf).  Their dq is exactly 0, they add nothing to dk and dv, and the
    rest is held to the plain version."""
    B, Sq, Skv, H, KVH, D, window = 1, 100, 40, 2, 1, 64, 16
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, D, seed=3)
    out, lse = _forward(q, k, v, True, window)
    assert bool(torch.isinf(lse[:, :, 55:]).all())
    got = split_flash_bwd(q, k, v, out, do, lse, causal=True, window=window)
    assert float(got[0][:, 55:].float().abs().max()) == 0.0
    want = ref_flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                   window=window)
    assert _excess(got, want) <= 1
    cut = split_flash_bwd(q[:, :55], k, v, out[:, :55], do[:, :55],
                          lse[:, :, :55], causal=True, window=window)
    assert torch.equal(got[1], cut[1]) and torch.equal(got[2], cut[2])


@pytest.mark.parametrize("rounded", ["p", "ds"])
def test_one_bf16_rounding_fails_the_check(rounded):
    """P (into dV) or dS (into dQ and dK) rounded once to bf16: some
    gradient lands more than one bf16 ulp from the fp32 plain version at
    Hymba's geometry; the two-part split stays within one."""
    B, Sq, Skv, H, KVH, D, causal, window = GEOMETRIES[0]
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, D, seed=0)
    out, lse = _forward(q, k, v, causal, window)
    kw = dict(causal=causal, window=window)
    want = ref_flash_attention_bwd(q, k, v, out, do, lse, **kw)
    once = split_flash_bwd(q, k, v, out, do, lse, **kw,
                           split_p=rounded != "p", split_ds=rounded != "ds")
    assert _excess(once, want) > 1.5
    assert _excess(split_flash_bwd(q, k, v, out, do, lse, **kw), want) <= 1


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 48, "wgmma"),
    (torch.bfloat16, 24, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_route_rule(dtype, head_dim, route):
    """``ops.flash_bwd_route``: the tensor-core backward for bf16 at head
    dims that are multiples of 16, the SIMT kernel for the rest (fp32
    stays in fp32); on CPU tensors neither runs, and no route counts a
    launch."""
    assert ops.flash_bwd_route(dtype, head_dim) == route
    before = dict(ops.flash_attention_backward.route_launches)
    q = torch.zeros(1, 3, 2, head_dim, dtype=dtype, requires_grad=True)
    k = torch.zeros(1, 3, 1, head_dim, dtype=dtype, requires_grad=True)
    ops.flash_attention(q, k, k).float().sum().backward()
    assert q.grad is not None
    assert ops.flash_attention_backward.route_launches == before
