"""The port's encoder-decoder family (Whisper: an encoder over stub frame
embeddings, a decoder with cross-attention, tied embeddings) against the
JAX package's.

Smoke config (2 + 2 layers, d_model 64, 4/4 heads of 16) with perturbed
parameters (``tests/test_torch_lm_dense.py``'s helpers); tolerances as
there: 1e-5 in float32, 5e-2 in bfloat16.  Frames are seeded numpy draws
(the frontend is a stub in both packages).  ``lm_decode.serve`` against
JAX's: ``tests/test_torch_lm_encdec_serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import lm_decode, steps  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm_dense import (B, TOL, configs, jax_init, np32,  # noqa: E402
                                 perturbed, tokens)

torch.set_num_threads(2)

ARCH = "whisper-medium"
FRAMES = 12


def frames(cfg, n=FRAMES, seed=0):
    """Seeded (B, n, d) frames: JAX's array and the port's tensor, both in
    the config's dtype."""
    x = np.random.RandomState(seed).randn(B, n, cfg.d_model)
    jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    return jx, torch.from_numpy(np.array(np32(jx))).to(LM._dtype(cfg))


def test_encdec_params_have_jax_names_shapes_and_dtypes():
    """The encoder's stacked dense blocks under ``encoder``, ``enc_ln_f``,
    the decoder's ``ln_x`` / ``xattn``; no ``head`` (tied embeddings)."""
    cfg, jcfg = configs(ARCH)
    flat = params_from_jax(jax.device_get(jax_init(jcfg, 0)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name
    assert "head" not in own and "enc_ln_f/scale" in own
    assert own["encoder/attn/wq"].shape == (2, 64, 64)
    assert own["layers/xattn/wk"].shape == (2, 64, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_cache_match_jax(dtype):
    """The encoder over 12 frames (plus the sinusoids, [sin | cos]) and
    every decoder layer's cross-attention K/V built from it."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg)
    jx, tx = frames(cfg)
    want, jcross = jax.jit(lambda p, f: (JLM.encode(p, jcfg, f),
                                         JLM.build_cross_cache(p, jcfg, f))
                           )(jp, jx)
    with torch.no_grad():
        got = LM.encode(tp, cfg, tx)
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])
    with torch.no_grad():
        cross = LM.build_cross_cache(tp, cfg, tx)
    for name in ("k", "v"):
        assert tuple(cross[name].shape) == (2, B, FRAMES, 4, 16)
        np.testing.assert_allclose(np32(cross[name]), np32(jcross[name]),
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_forward_train_matches_jax(dtype):
    """10 tokens scored over 12 frames through ``make_prefill_step``: the
    decoder's causal self-attention and its cross-attention (the flash
    kernel's plain version), the tied head; aux 0."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=1)
    jx, tx = frames(cfg, seed=2)
    toks = tokens(cfg, 10, seed=3)
    tgt = np.roll(toks, -1, 1)
    want, jaux = jax.jit(lambda p, b: JLM.forward_train(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
             "frames": jx})
    got = steps.make_prefill_step(cfg)(
        {"model": tp}, {"tokens": torch.from_numpy(toks),
                        "targets": torch.from_numpy(tgt), "frames": tx})
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])
    assert float(jaux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_decode_steps_match_jax(dtype):
    """4 decode steps through ``make_serve_step`` over the cross cache of
    12 frames (the sinusoid at each index, cross-attention with one
    query): logits, next tokens, the self-attention cache."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=4)
    jx, tx = frames(cfg, seed=5)
    toks = tokens(cfg, 4, seed=6)
    jc = JLM.init_cache(jcfg, B, 8)
    jc["cross"] = jax.jit(lambda p, f: JLM.build_cross_cache(p, jcfg, f))(
        jp, jx)
    tc = LM.init_cache(cfg, B, 8)
    assert tc["cross"] is None
    with torch.no_grad():
        tc["cross"] = LM.build_cross_cache(tp, cfg, tx)
    jserve = jax.jit(lambda p, t, c: jax_steps.make_serve_step(jcfg)(
        {"model": p}, t, c, {}))
    serve = steps.make_serve_step(cfg)
    for t in range(4):
        jn, jl, jc = jserve(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tn, tl, tc = serve({"model": tp}, torch.from_numpy(toks[:, t:t + 1]),
                           tc)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
        if dtype == "float32":
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tc["index"] == int(jc["index"]) == 4
    np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                  np.asarray(jc["kv"]["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc["kv"][name]),
                                   np32(jc["kv"][name]), atol=TOL[dtype])


def test_decode_without_a_cross_cache_raises():
    cfg = get_config(ARCH, smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator())
    with pytest.raises(ValueError, match="build_cross_cache"):
        LM.decode_step(params, cfg, torch.zeros(B, 1, dtype=torch.int64),
                       LM.init_cache(cfg, B, 4))


def test_encoder_self_attention_is_causal_in_both_packages():
    """ROADMAP.md queue 3, reference item 12: JAX's ``encode`` runs its
    self-attention through ``attention_sublayer`` without a cache, whose
    flash call is causal (though the comment there reads "non-causal"),
    so frame 0's encoder output does not move when later frames change.
    The port keeps that; the last frame's output does move."""
    cfg, jcfg = configs(ARCH, "float32")
    jp, tp = perturbed(jcfg, cfg, seed=7)
    jx, tx = frames(cfg, seed=8)
    jx2 = jx.at[:, 1:].set(jx[:, 1:] + 1.0)
    tx2 = tx.clone()
    tx2[:, 1:] += 1.0
    jenc = jax.jit(lambda p, f: JLM.encode(p, jcfg, f))
    ja, jb = np32(jenc(jp, jx)), np32(jenc(jp, jx2))
    with torch.no_grad():
        ta, tb = np32(LM.encode(tp, cfg, tx)), np32(LM.encode(tp, cfg, tx2))
    for a, b in ((ja, jb), (ta, tb)):
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert np.abs(a[:, -1] - b[:, -1]).max() > 1e-2
    np.testing.assert_allclose(tb, jb, atol=TOL["float32"])


def test_whisper_cli_on_the_cpu(capsys):
    """``python -m repro_torch.launch.lm_decode --arch whisper-medium``:
    the cross cache over ``prompt_len`` seeded frames."""
    assert lm_decode.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3", "--gen", "4",
                           "--seed", "1"]) == 0
    assert "generated (2, 4) tokens" in capsys.readouterr().out
