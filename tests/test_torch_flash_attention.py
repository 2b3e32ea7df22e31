"""The port's flash attention against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs its plain
version (``repro_torch.kernels.ref.ref_flash_attention``); here it is held
against the Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it) and against the model's chunked jnp layer
(``repro.models.layers.flash_attention``) on the six ``FLASH_CASES`` of
``tests/test_kernels.py``, and against ``repro.kernels.ref`` with a query
offset and a kv length.  Inputs are drawn with numpy from a seed; a bf16
case rounds the same fp32 draws to bf16 on both sides.  Tolerances are the
JAX tests': 2e-5 in fp32, 3e-2 in bf16.  The CUDA kernel is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); the last tests show that ``chip_smoke.py``'s
entry-by-entry check fails a kernel with a misplaced window or a dropped
key tile at the scoring pass's geometry, and passes one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ref import ref_flash_attention as jax_ref  # noqa: E402
from repro.models.layers import flash_attention as jax_layer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_flash_attention  # noqa: E402
from repro_torch.models import layers  # noqa: E402

torch.set_num_threads(2)

FLASH_CASES = [
    # (B, Sq, Skv, H, KVH, D, causal, window, bf16, tol): tests/test_kernels.py
    (2, 128, 128, 4, 2, 64, True, 0, False, 2e-5),
    (1, 100, 100, 8, 8, 32, True, 0, False, 2e-5),
    (2, 64, 256, 4, 1, 128, False, 0, False, 2e-5),
    (1, 256, 256, 4, 2, 64, True, 64, False, 2e-5),
    (1, 64, 64, 2, 2, 64, True, 0, True, 3e-2),
    (1, 17, 33, 2, 1, 16, True, 0, False, 2e-5),   # ragged
]


def _inputs(B, Sq, Skv, H, KVH, D, bf16, seed):
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Skv, KVH, D).astype(np.float32),
            rng.randn(B, Skv, KVH, D).astype(np.float32))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_matches_pallas_and_the_jax_layer(case):
    B, Sq, Skv, H, KVH, D, causal, window, bf16, tol = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, H, KVH, D, bf16, seed=Sq)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    layer = jax_layer(jq, jk, jv, causal=causal, window=window, chunk=64)
    np.testing.assert_allclose(_np(got), _np(layer), atol=tol)
    np.testing.assert_allclose(
        _np(layers.flash_attention(q, k, v, causal=causal, window=window)),
        _np(got), atol=0)


@pytest.mark.parametrize("q_offset,kv_len,window", [(40, 57, 0), (40, 57, 16),
                                                    (0, 33, 8)])
def test_query_offset_and_kv_len(q_offset, kv_len, window):
    """The cached-prefill form: 17 queries at positions q_offset.. against
    a 64-slot cache of which kv_len are valid; every row attends a key."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 17, 64, 4, 2, 32, False, seed=5)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    want = jax_ref(jq, jk, jv, causal=True, window=window, q_offset=q_offset,
                   kv_len=kv_len)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    layer = jax_layer(jq, jk, jv, causal=True, window=window,
                      q_offset=q_offset, kv_len=kv_len, chunk=16)
    np.testing.assert_allclose(_np(got), _np(layer), atol=2e-5)


def test_row_without_a_key_is_zero():
    """kv_len = 0: no row attends a key; the port writes zeros (the kernel
    does too) where JAX's oracle would average every key."""
    _, (q, k, v) = _inputs(1, 5, 8, 2, 1, 16, False, seed=1)
    got = ops.flash_attention(q, k, v, causal=False, kv_len=0)
    assert torch.equal(got, torch.zeros_like(q))


def test_refuses_grad_and_bad_operands():
    _, (q, k, v) = _inputs(1, 8, 8, 2, 1, 16, False, seed=2)
    # differentiable now, except where only cached decode calls it
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.flash_attention(q.requires_grad_(), k, v, q_offset=2)
    q = q.detach()
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="do not agree"):
        ops.flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError, match="do not agree"):
        ops.flash_attention(q[:, :, :1].repeat(1, 1, 3, 1),
                            k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def path_geometry():
    """One query and one kv head at the scoring pass's sequence and window
    (4,096 tokens, window 2,048, head dim 64), with the plain version's
    output in bf16 and fp32."""
    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(s, generator=g) for s in
           ((1, 4096, 1, 64), (1, 4096, 1, 64), (1, 4096, 1, 64))]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dt) for x in qkv)
        kw = dict(causal=True, window=2048)
        out[dt] = {
            "want": ref_flash_attention(q, k, v, **kw),
            "window off by one": ref_flash_attention(q, k, v, causal=True,
                                                     window=2047),
            "last key tile dropped": ref_flash_attention(q, k, v,
                                                         kv_len=4032, **kw)}
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("fault", ["window off by one",
                                   "last key tile dropped"])
def test_chip_smoke_check_catches_a_wrong_kernel(path_geometry, dtype,
                                                 fault):
    """``chip_smoke.py`` holds the kernel entry by entry (``_held``): at the
    scoring pass's geometry, outputs of a kernel that misplaced the window
    start or skipped the last key tile fail it, in bf16 and fp32."""
    cs = _chip_smoke()
    runs = path_geometry[dtype]
    bf16 = dtype == torch.bfloat16
    assert cs._held(runs["want"].clone(), runs["want"], bf16)["excess"] == 0
    assert cs._held(runs[fault], runs["want"], bf16)["excess"] > 1


def test_chip_smoke_check_allows_one_bf16_ulp(path_geometry):
    """Two roundings of the same fp32 value to bf16 may land one ulp
    apart: that passes ``_held``, two ulps do not."""
    cs = _chip_smoke()
    want = path_geometry[torch.bfloat16]["want"]
    bits = want.view(torch.int16)
    step = (want != 0).to(torch.int16)       # one ulp away from zero
    one, two = ((bits + n * step).view(torch.bfloat16) for n in (1, 2))
    assert cs._held(one, want, True)["excess"] <= 1
    assert cs._held(two, want, True)["excess"] > 1
