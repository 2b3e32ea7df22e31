"""The port's LM tier (Hymba, the hybrid family) against the JAX package's.

JAX initializes Hymba's smoke config (2 layers, d_model 64, 4/2 heads of
16, ssm_state 4, window 8), ``repro_torch.convert.params_from_jax`` carries
the parameters across and :func:`repro_torch.models.lm.load_params` loads
them.  Both packages then score the same tokens (``forward_train``: the
flash-attention and scan plain versions over the whole sequence) and run
12 decode steps from them, more than the 8-slot window, so the rotating
cache wraps.  Tolerances: 1e-4 in float32 (the same math in other orders),
5e-2 in bfloat16 (the two frameworks round bf16 matmuls at other places).
Greedy ``lm_decode.serve`` tokens must be equal to JAX's in float32.
Tokens are drawn with numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.launch import lm_decode as jax_lm_decode  # noqa: E402
from repro.models import config as jax_config  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import lm_decode, steps  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
B = 2
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _configs(dtype):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True),
                               dtype=dtype)
    return cfg, jcfg


def _params(cfg, jcfg, seed=0):
    jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = LM.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                        device=torch.device("cpu"))
    LM.load_params(tp, params_from_jax(jax.device_get(jp)))
    return jp, tp


def _tokens(cfg, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def test_model_config_fields_match_jax():
    """Same field names, defaults and order, so a positional config means
    the same thing; the same configs and analytic parameter counts."""
    f_port = [(f.name, f.default) for f in
              dataclasses.fields(port_config.ModelConfig)]
    f_jax = [(f.name, f.default) for f in
             dataclasses.fields(jax_config.ModelConfig)]
    assert f_port == f_jax
    assert [f.name for f in dataclasses.fields(port_config.ShapeConfig)] \
        == [f.name for f in dataclasses.fields(jax_config.ShapeConfig)]
    assert {k: dataclasses.astuple(v)
            for k, v in port_config.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jax_config.SHAPES.items()}
    for smoke in (False, True):
        assert dataclasses.astuple(get_config(ARCH, smoke=smoke)) \
            == dataclasses.astuple(jax_registry.get_config(ARCH, smoke=smoke))
    for arch in jax_registry.ARCH_IDS:
        jcfg = jax_registry.get_config(arch)
        cfg = port_config.ModelConfig(*dataclasses.astuple(jcfg))
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        for shape in jax_config.SHAPES.values():
            assert port_config.cell_is_runnable(
                cfg, port_config.SHAPES[shape.name]) \
                == jax_config.cell_is_runnable(jcfg, shape)
    assert get_config(ARCH).param_count() == 1_392_030_400


@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_port_config_equals_jax(arch):
    """Every architecture of the reference, full and smoke: the port's
    config equals JAX's field by field, with the same analytic parameter
    counts and padded expert count (qwen2-moe's 60 -> 64)."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        jcfg = jax_registry.get_config(arch, smoke=smoke)
        for f in dataclasses.fields(jcfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.padded_experts == jcfg.padded_experts
    if arch == "qwen2-moe-a2.7b":
        assert get_config(arch).padded_experts == 64


def test_params_have_jax_names_shapes_and_dtypes():
    cfg, jcfg = _configs("bfloat16")
    flat = params_from_jax(jax.device_get(
        JLM.init_params(jax.random.PRNGKey(0), jcfg)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name
    assert own["layers/attn/wq"].shape == (2, 64, 64)


def test_params_from_jax_carries_bf16_leaves_bit_for_bit():
    """An ``ml_dtypes.bfloat16`` leaf (every LM config's default dtype)
    raised TypeError in ``torch.from_numpy``; its bits now cross as is."""
    leaf = (np.arange(-6, 6, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    got = params_from_jax({"a": {"w": leaf}, "b": np.ones(3, np.float32)})
    assert got["a/w"].dtype == torch.bfloat16
    assert np.array_equal(got["a/w"].view(torch.int16).numpy(),
                          leaf.view(np.int16))
    assert got["b"].dtype == torch.float32
    cfg, jcfg = _configs("bfloat16")
    jp, tp = _params(cfg, jcfg)
    jflat = params_from_jax(jax.device_get(jp))
    for name, t in tp.flat().items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.view(torch.int16), jflat[name].view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax(dtype):
    """20 tokens, past the 8-token window: the flash mask bites."""
    cfg, jcfg = _configs(dtype)
    jp, tp = _params(cfg, jcfg)
    toks = _tokens(cfg, 20)
    tgt = np.roll(toks, -1, 1)
    want, _ = JLM.forward_train(jp, jcfg, {"tokens": jnp.asarray(toks),
                                           "targets": jnp.asarray(tgt)})
    got = steps.make_prefill_step(cfg)(
        {"model": tp}, {"tokens": torch.from_numpy(toks),
                        "targets": torch.from_numpy(tgt)})
    assert got.shape == (B, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax_through_a_wrapped_window(dtype):
    cfg, jcfg = _configs(dtype)
    jp, tp = _params(cfg, jcfg)
    toks = _tokens(cfg, 12, seed=1)
    jstep = jax.jit(lambda p, t, c: JLM.decode_step(p, jcfg, t, c))
    jc = JLM.init_cache(jcfg, B, 16)
    tc = LM.init_cache(cfg, B, 16)
    assert tc["kv"]["k"].shape == (2, B, 8, 2, 16)       # the window
    serve = steps.make_serve_step(cfg)
    for t in range(12):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        nxt, tl, tc = serve({"model": tp}, torch.from_numpy(toks[:, t:t + 1]),
                            tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
        assert torch.equal(nxt, torch.argmax(tl, -1).to(torch.int32))
        assert tc["index"] == int(jc["index"]) == t + 1
        np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                      np.asarray(jc["kv"]["pos"]))
        np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(_np(tc["kv"]["k"]), _np(jc["kv"]["k"]),
                               atol=TOL[dtype])


def test_greedy_serve_tokens_equal_jax():
    """``lm_decode.serve`` with JAX's weights and prompt (both drawn from
    ``PRNGKey(seed)`` as JAX's ``serve`` draws them): 6 prompt + 10
    generated tokens through the 8-slot window, token for token."""
    cfg, jcfg = _configs("float32")
    seed, prompt_len, gen = 3, 6, 10
    jp, tp = _params(cfg, jcfg, seed=seed)
    prompt = jax.random.randint(jax.random.PRNGKey(seed), (B, prompt_len),
                                0, cfg.vocab_size)
    want, _ = jax_lm_decode.serve(jcfg, batch=B, prompt_len=prompt_len,
                                  gen=gen, seed=seed, greedy=True)
    got, tps = lm_decode.serve(cfg, batch=B, prompt_len=prompt_len, gen=gen,
                               seed=seed, greedy=True, device="cpu",
                               params=tp,
                               prompt=torch.from_numpy(np.array(prompt)))
    assert tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_teacher_forcing():
    """The bar of ``tests/test_models.py:82-100`` on the port alone (bf16,
    the config's own dtype): step-by-step decode log-probs equal the
    scoring pass's within 0.05."""
    cfg = get_config(ARCH, smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 8, seed=2))
    with torch.no_grad():
        lp, _ = LM.forward_train(params, cfg, {
            "tokens": toks, "targets": torch.roll(toks, -1, 1)})
        cache = LM.init_cache(cfg, B, 16)
        errs = []
        for t in range(7):
            logits, cache = LM.decode_step(params, cfg, toks[:, t:t + 1],
                                           cache)
            step_lp = torch.log_softmax(logits, -1).gather(
                -1, toks[:, t + 1:t + 2].long())[:, 0]
            errs.append((step_lp - lp[:, t].float()).abs().max())
    assert float(max(errs)) < 0.05


def test_cli_on_the_cpu(capsys):
    assert lm_decode.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3", "--gen", "4",
                           "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out


def test_unported_paths_raise():
    """The int8 cache raises where the reference reads it without its
    scales (the window, ROADMAP.md queue 3 reference item 11)."""
    cfg = get_config(ARCH, smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator())
    toks = torch.zeros(B, 4, dtype=torch.int64)
    q8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="reference item 11"):
        LM.decode_step(params, q8, toks[:, :1], LM.init_cache(q8, B, 8))


def _jax_gumbel_draws(seed, gen, shape):
    """The Gumbel noise JAX's ``serve`` draws for its ``gen`` sampled
    tokens: ``key, k2 = split(key)`` per token from ``PRNGKey(seed)``, then
    ``jax.random.categorical(k2, logits)``, which in JAX 0.9 is
    ``argmax(gumbel(k2, logits.shape, logits.dtype) + logits)`` (the decode
    logits are float32)."""
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(gen):
        key, k2 = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(k2, shape, jnp.float32)))
    return np.stack(draws)


def test_sampled_serve_tokens_equal_jax():
    """``lm_decode.serve`` with JAX's weights, prompt and replayed Gumbel
    draws samples JAX's tokens (``greedy=False``), token for token: 6
    prompt + 10 sampled tokens through the 8-slot window, in float32."""
    cfg, jcfg = _configs("float32")
    seed, prompt_len, gen = 3, 6, 10
    jp, tp = _params(cfg, jcfg, seed=seed)
    prompt = jax.random.randint(jax.random.PRNGKey(seed), (B, prompt_len),
                                0, cfg.vocab_size)
    want, _ = jax_lm_decode.serve(jcfg, batch=B, prompt_len=prompt_len,
                                  gen=gen, seed=seed, greedy=False)
    draws = _jax_gumbel_draws(seed, gen, (B, cfg.vocab_size))
    got, _ = lm_decode.serve(cfg, batch=B, prompt_len=prompt_len, gen=gen,
                             seed=seed, device="cpu", params=tp,
                             prompt=torch.from_numpy(np.array(prompt)),
                             noise=torch.from_numpy(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same draws as a source noise(t) -> (batch, vocab)
    again, _ = lm_decode.serve(cfg, batch=B, prompt_len=prompt_len, gen=gen,
                               seed=seed, device="cpu", params=tp,
                               prompt=torch.from_numpy(np.array(prompt)),
                               noise=lambda t: torch.from_numpy(draws[t]))
    assert torch.equal(again, got)
    # the greedy tokens differ: the noise was used
    greedy, _ = jax_lm_decode.serve(jcfg, batch=B, prompt_len=prompt_len,
                                    gen=gen, seed=seed, greedy=True)
    assert not np.array_equal(np.asarray(greedy), np.asarray(want))


def test_serve_refuses_noise_of_another_shape():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="noise has shape"):
        lm_decode.serve(cfg, batch=B, prompt_len=2, gen=3, device="cpu",
                        noise=torch.zeros(3, B, cfg.vocab_size - 1))
