"""The arithmetic of the tensor-core flash kernel, emulated on the CPU.

``flash_attention_wgmma.cu`` runs the scores on bf16 tensor cores (products
exact in fp32), keeps the online softmax in fp32 over 64-key tiles, and
forms P V from P split in two bf16 parts, ``P_hi = bf16(P)`` and
``P_lo = bf16(P - P_hi)``, both products summed into one fp32 accumulator.
:func:`split_p_attention` repeats that arithmetic in plain torch: bf16
operands, fp32 sums, the same tiles and the same splitting.  It is held to
the plain version (``repro_torch.kernels.ref.ref_flash_attention``) and to
JAX's oracle (``repro.kernels.ref.ref_flash_attention``) under the check
``chip_smoke.py`` holds the kernel to, entry by entry: |err| <= 2^-7 |want|
+ 1e-3 rms(want) (``_held``, excess <= 1: one bf16 ulp).  With P rounded
once to bf16, the same emulation fails that check at the stated geometries
and seeds: that is why the kernel splits P.  Inputs are drawn with numpy
from a seed.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_flash_attention as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (attention_mask,  # noqa: E402
                                     ref_flash_attention)

torch.set_num_threads(2)

#: (B, S, H, KVH, D, window): Hymba's head grouping (25/5 cut to 5/1) and
#: head dim, causal, the window a quarter to half of the sequence
GEOMETRIES = [(1, 256, 5, 1, 64, 128), (1, 512, 5, 1, 64, 256),
              (2, 300, 4, 2, 32, 100)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_p_attention(q, k, v, *, causal, window, split=True, block=64):
    """Attention as the tensor-core kernel computes it: scores q.k in fp32
    from bf16 operands, an online softmax over ``block``-key tiles (running
    max, denominator from the fp32 P, the accumulator rescaled per tile), and
    P V from bf16(P) plus, with ``split``, bf16(P - bf16(P)); output in q's
    dtype.  q: (B, Sq, H, D); k/v: (B, Skv, KVH, D)."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).permute(0, 2, 1, 3)
    kf, vf = (x.to(f32).repeat_interleave(H // KVH, 2).permute(0, 2, 1, 3)
              for x in (k, v))
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=0,
                          kv_len=None, device=q.device)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    o = torch.zeros(B, H, Sq, D)
    for kt in range(0, Skv, block):
        s = qf @ kf[:, :, kt:kt + block].transpose(-1, -2) / math.sqrt(D)
        s = torch.where(mask[:, kt:kt + block], s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1)
        p_hi = p.to(torch.bfloat16).to(f32)
        pv = p_hi @ vf[:, :, kt:kt + block]
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).to(f32)
            pv = pv + p_lo @ vf[:, :, kt:kt + block]
        o = o * corr[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _inputs(B, S, H, KVH, D, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_split_p_is_held_to_the_plain_version_and_jax(geometry, seed):
    B, S, H, KVH, D, window = geometry
    (q, k, v), (jq, jk, jv) = _inputs(B, S, H, KVH, D, seed)
    got = split_p_attention(q, k, v, causal=True, window=window)
    held = _chip_smoke()._held
    want = ref_flash_attention(q, k, v, causal=True, window=window)
    assert held(got, want, True)["excess"] <= 1
    jax_want = torch.from_numpy(np.array(
        jax_ref(jq, jk, jv, causal=True, window=window).astype(jnp.float32)))
    assert held(got, jax_want, True)["excess"] <= 1


@pytest.mark.parametrize("geometry", GEOMETRIES[:2], ids=str)
def test_p_rounded_once_fails_the_check(geometry):
    """P rounded once to bf16 before P V: outputs land more than one bf16
    ulp from the fp32 plain version (excess 4.6 and 5.9 at these two
    geometries, seed 0; the split recipe 0.76 and 0.81)."""
    B, S, H, KVH, D, window = geometry
    (q, k, v), _ = _inputs(B, S, H, KVH, D, seed=0)
    want = ref_flash_attention(q, k, v, causal=True, window=window)
    held = _chip_smoke()._held
    once = split_p_attention(q, k, v, causal=True, window=window, split=False)
    assert held(once, want, True)["excess"] > 2
    split = split_p_attention(q, k, v, causal=True, window=window)
    assert held(split, want, True)["excess"] <= 1


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 48, "wgmma"),
    (torch.bfloat16, 24, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_route_rule(dtype, head_dim, route):
    """``ops.flash_route``: the tensor-core kernel for bf16 at head dims
    that are multiples of 16, the SIMT kernel for the rest (fp32 stays in
    fp32); on CPU tensors neither runs, and no route counts a launch."""
    assert ops.flash_route(dtype, head_dim) == route
    before = dict(ops.flash_attention.route_launches)
    q = torch.zeros(1, 3, 2, head_dim, dtype=dtype)
    k = torch.zeros(1, 3, 1, head_dim, dtype=dtype)
    ops.flash_attention(q, k, k)
    assert ops.flash_attention.route_launches == before
