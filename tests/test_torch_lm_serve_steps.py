"""The port's serve steps of the LM tier against the JAX package's:
fused multi-token decode (``decode_steps > 1``), the cached S > 1 call
(the flash branch with ``q_offset`` and ``kv_len``) and the int8 KV cache,
with the reference's unscaled int8 read (``ROADMAP.md`` queue 3, reference
item 11) shown on JAX's side.  Smoke configs with perturbed parameters
(``tests/test_torch_lm_dense.py``'s helpers); tolerances as there: 1e-5
in float32, 5e-2 in bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm_dense import (B, TOL, configs, jax_decode,  # noqa: E402
                                 jax_init, jax_sublayer, np32, perturbed,
                                 tokens)

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["qwen2-72b", "rwkv6-1.6b", "hymba-1.5b"])
def test_fused_decode_steps_equal_four_single_steps_and_jax(arch):
    """``decode_steps=4``: one call takes four greedy steps and returns the
    last token and logits, ``index`` 4; equal to four one-step calls
    (bitwise: the same ops) and to JAX's fused ``make_serve_step`` (as
    ``tests/test_serving.py:45-66``), in float32, for each family."""
    cfg, jcfg = configs(arch, "float32")
    jp, tp = perturbed(jcfg, cfg, seed=8)
    tok0 = tokens(cfg, 1, seed=8)
    one = steps.make_serve_step(cfg)
    cache = LM.init_cache(cfg, B, 16)
    tok = torch.from_numpy(tok0)
    for _ in range(4):
        nxt, logits, cache = one({"model": tp}, tok, cache)
        tok = nxt[:, None]
    cfg4, jcfg4 = (dataclasses.replace(c, decode_steps=4)
                   for c in (cfg, jcfg))
    cache4 = LM.init_cache(cfg4, B, 16)
    last, logits4, cache4 = steps.make_serve_step(cfg4)(
        {"model": tp}, torch.from_numpy(tok0), cache4)
    assert cache4["index"] == 4 and last.dtype == torch.int32
    assert torch.equal(last, nxt) and torch.equal(logits4, logits)
    for name, t in cache4.items():
        want = cache[name]
        if isinstance(t, dict):
            assert all(torch.equal(t[k], want[k]) for k in t), name
        elif isinstance(t, torch.Tensor):
            assert torch.equal(t, want), name
    jserve = jax.jit(lambda p, t, c: jax_steps.make_serve_step(jcfg4)(
        {"model": p}, t, c, {}))
    jlast, jlogits, jcache = jserve(jp, jnp.asarray(tok0),
                                    JLM.init_cache(jcfg4, B, 16))
    assert int(jcache["index"]) == 4
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_allclose(np32(logits4), np32(jlogits),
                               atol=TOL["float32"])


def _layer0(jp):
    return jax.tree_util.tree_map(lambda a: a[0], jp["layers"])


def _filled_cache(cfg, C, n, seed, dtype):
    """A layer's cache with ``n`` random K/V tokens at positions 0..n-1 and
    the rest empty (positions -1), as numpy."""
    rs = np.random.RandomState(seed)
    shape = (B, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = (np.where(np.arange(C)[None, :, None, None] < n,
                     rs.randn(*shape), 0.0).astype(np.float32)
            for _ in range(2))
    pos = np.where(np.arange(C) < n, np.arange(C), -1)
    pos = np.broadcast_to(pos, (B, C)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ({"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt),
             "pos": jnp.asarray(pos)},
            {"k": torch.tensor(np32(jnp.asarray(k, jdt))).to(LM._dtype(cfg)),
             "v": torch.tensor(np32(jnp.asarray(v, jdt))).to(LM._dtype(cfg)),
             "pos": torch.from_numpy(pos.copy())})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_multi_token_call_matches_jax(dtype):
    """JAX's ``attention_sublayer`` with a 12-slot cache holding 5 tokens,
    ``cache_index`` 5 and S = 4 new tokens (the flash branch with
    ``q_offset`` 5 and ``kv_len`` 9) against the port's: the output, the
    K/V written to slots 5-8 and the stored positions."""
    cfg, jcfg = configs("qwen2.5-32b", dtype)
    jp, tp = perturbed(jcfg, cfg, seed=2)
    jcache, tcache = _filled_cache(cfg, 12, 5, seed=3, dtype=dtype)
    x = np.random.RandomState(4).randn(B, 4, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 9), (B, 4)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, jnew = jax_sublayer(jcfg, _layer0(jp)["attn"], jnp.asarray(x, jdt),
                              jnp.asarray(pos), jcache, 5)
    got, tnew = LM.attention_sublayer(
        LM._layer(tp["layers"], 0)["attn"],
        torch.tensor(np32(jnp.asarray(x, jdt))).to(LM._dtype(cfg)), cfg,
        torch.from_numpy(pos.copy()), cache=tcache, cache_index=5)
    assert tnew is tcache                       # written in place
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tnew[name]), np32(jnew[name]),
                                   atol=TOL[dtype])
    np.testing.assert_array_equal(tnew["pos"].numpy(),
                                  np.asarray(jnew["pos"]))
    assert list(tnew["pos"][0].numpy()) == list(range(9)) + [-1] * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_decode_matches_jax(dtype):
    """8 decode steps on the int8 cache against JAX's, logits to the
    dtype's tolerance.  In float32 every code is within one of JAX's (both
    round half to even; a quantized value may differ in the last place)
    and the scales agree to float rounding.  In bf16 the first layer's
    K/V are projections of the same embeddings: codes within one, scales
    within one bf16 ulp of the largest |k| (at most 2^-7 of it: the two
    frameworks' bf16 products may round a value apart); the second layer's
    inputs carry the first's bf16 rounding, so there fewer than 1 % of its
    codes may differ by more than one, and its scales lie within two bf16
    ulps of the largest |k| (2^-6 of it)."""
    cfg, jcfg = configs("qwen2.5-32b", dtype, kv_cache_dtype="int8")
    jp, tp = perturbed(jcfg, cfg, seed=5)
    toks = tokens(cfg, 8, seed=5)
    jstep = jax_decode(jcfg)
    jc = JLM.init_cache(jcfg, B, 16)
    tc = LM.init_cache(cfg, B, 16)
    assert tc["kv"]["k"].dtype == torch.int8
    assert tc["kv"]["k_scale"].shape == (2, B, 16, 2)
    for t in range(8):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = LM.decode_step(tp, cfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
    layers = 2 if dtype == "float32" else 1
    srtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name in ("k", "v"):
        off = np.abs(tc["kv"][name].numpy().astype(np.int32)
                     - np.asarray(jc["kv"][name], np.int32))
        assert off[:layers].max() <= 1, name
        assert (off[layers:] > 1).sum() <= 0.01 * off[layers:].size, name
        scale = tc["kv"][name + "_scale"].numpy()
        jscale = np.asarray(jc["kv"][name + "_scale"])
        np.testing.assert_allclose(scale[:layers], jscale[:layers],
                                   rtol=srtol)
        np.testing.assert_allclose(scale[layers:], jscale[layers:],
                                   rtol=2.0 ** -6)
    assert int(np.abs(tc["kv"]["k"].numpy()).max()) == 127


def _decode_logprobs(cfg, params, toks, n):
    cache = LM.init_cache(cfg, B, 16)
    out = []
    for t in range(n):
        logits, cache = LM.decode_step(params, cfg, toks[:, t:t + 1], cache)
        out.append(torch.log_softmax(logits, -1))
    return torch.stack(out, 1), cache


def test_int8_cache_tracks_the_bf16_cache():
    """The bars of ``tests/test_serving.py:28-43`` on the port alone: 8
    steps on the int8 cache against the bf16 cache of the same model, mean
    |d log p| < 0.05 and top-1 agreement > 0.95; the int8 cache holds a
    quarter of the K/V bytes plus 4 bytes of scales per (token, head)."""
    cfg = get_config("qwen2.5-32b", smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(cfg, 8, seed=6))
    with torch.no_grad():
        ref, c16 = _decode_logprobs(cfg, params, toks, 8)
        q8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        quant, c8 = _decode_logprobs(q8, params, toks, 8)
    drift = float((ref - quant).abs().mean())
    agree = float((ref.argmax(-1) == quant.argmax(-1)).float().mean())
    assert drift < 0.05 and agree > 0.95, (drift, agree)
    nbytes = lambda c: sum(t.numel() * t.element_size()
                           for n, t in c["kv"].items() if n != "pos")
    hd = cfg.resolved_head_dim
    assert nbytes(c8) / nbytes(c16) == pytest.approx((hd + 4) / (2 * hd))


def test_int8_windowed_read_is_unscaled_in_jax_and_refused_by_the_port():
    """ROADMAP.md queue 3 reference item 11, at the sublayer: JAX's
    ``attention_sublayer`` over an int8 window cache (Hymba's smoke config,
    window 8) attends the int8 codes without their scales.  Against the
    same call on the dequantized cache (codes times scales; float32) its
    output is off by far more than the quantization error; the port
    raises there, and for an int8 cached S > 1 call."""
    _, jcfg = configs("hymba-1.5b", "float32")
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    p = _layer0(jax_init(jcfg, 0))["attn"]
    rs = np.random.RandomState(7)
    C, n = 8, 5
    kv = rs.randn(2, B, C, jcfg.num_kv_heads, 16).astype(np.float32)
    kv[:, :, n:] = 0.0
    scale = np.abs(kv).max(-1) / 127.0 + 1e-9
    codes = np.round(kv / scale[..., None]).astype(np.int8)
    pos = np.broadcast_to(np.where(np.arange(C) < n, np.arange(C), -1),
                          (B, C)).astype(np.int32)
    x = jnp.asarray(rs.randn(B, 1, jcfg.d_model).astype(np.float32))
    at = jnp.full((B, 1), n, jnp.int32)
    q8 = {"k": jnp.asarray(codes[0]), "v": jnp.asarray(codes[1]),
          "pos": jnp.asarray(pos), "k_scale": jnp.asarray(scale[0]),
          "v_scale": jnp.asarray(scale[1])}
    deq = {"k": jnp.asarray(codes[0] * scale[0][..., None]),
           "v": jnp.asarray(codes[1] * scale[1][..., None]),
           "pos": jnp.asarray(pos)}
    out8, _ = jax_sublayer(jcfg8, p, x, at, q8, n, window=C)
    outf, _ = jax_sublayer(jcfg, p, x, at, deq, n, window=C)
    gap = float(jnp.abs(out8 - outf).max())
    quant_err = float(np.abs(codes * scale[..., None] - kv).max())
    print(f"JAX int8 window read: max |out - out on the dequantized cache| "
          f"= {gap:.4g} (largest K/V quantization error {quant_err:.3g}, "
          f"max |out| {float(jnp.abs(outf).max()):.3g})")
    assert gap > 100 * quant_err * float(jnp.abs(outf).max())
    # the port refuses both readings
    cfg8 = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                               kv_cache_dtype="int8")
    params = LM.init_params(cfg8, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="reference item 11"):
        LM.decode_step(params, cfg8, torch.zeros(B, 1, dtype=torch.int64),
                       LM.init_cache(cfg8, B, 16))
    dense8 = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                                 kv_cache_dtype="int8")
    dp = LM.init_params(dense8, generator=torch.Generator())
    cache = LM.init_cache(dense8, B, 16)
    cache = {k: t[0] for k, t in cache["kv"].items()}
    h = torch.zeros(B, 3, dense8.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="reference item 11"):
        LM.attention_sublayer(LM._layer(dp["layers"], 0)["attn"], h, dense8,
                              torch.arange(3)[None].expand(B, 3), cache=cache,
                              cache_index=0)


def test_cache_overflow_raises():
    """JAX's unwindowed cache write drops what falls past the cache; the
    port refuses it."""
    cfg = get_config("qwen2.5-32b", smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator())
    cache = LM.init_cache(cfg, B, 2)
    tok = torch.zeros(B, 1, dtype=torch.int64)
    for _ in range(2):
        LM.decode_step(params, cfg, tok, cache)
    with pytest.raises(ValueError, match="do not fit a 2-slot cache"):
        LM.decode_step(params, cfg, tok, cache)


