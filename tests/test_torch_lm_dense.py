"""The port's dense LM family (qwen2 / qwen2.5, command-r) against the JAX
package's (the cached S > 1 call and the int8 KV cache:
``tests/test_torch_lm_serve_steps.py``).

JAX initializes each smoke config (2 layers, d_model 64, 4/2 heads of 16,
vocab 256; command-r-plus 96 wide, 6 heads), seeded numpy noise is added to
every leaf (JAX's initial values are zero biases and unit norms, which
would hide a missing bias add or a misplaced norm: :func:`perturbed`), and
both packages load the same values, the port through
``repro_torch.convert.params_from_jax``.  Tolerances: 1e-5 in float32 (the
same math in other orders), 5e-2 in bfloat16 (the two frameworks round
bf16 matmuls at other places; the Hymba tests' bar).  Tokens are drawn with
numpy from a seed.  The helpers here serve the RWKV6 and serve-step files
too; JAX's calls are jitted (eagerly each op compiles alone).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.launch import lm_decode as jax_lm_decode  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import lm_decode, steps  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402

torch.set_num_threads(2)

B = 2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DENSE = ["qwen2.5-32b", "command-r-35b"]      # QKV bias; tied, no bias


def configs(arch, dtype="bfloat16", **changes):
    """The port's and JAX's smoke config of ``arch``, in ``dtype``."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **changes)
    jcfg = dataclasses.replace(jax_registry.get_config(arch, smoke=True),
                               dtype=dtype, **changes)
    return cfg, jcfg


def _noise(name, shape, rs):
    """The noise added to leaf ``name``: the decay base ``w0`` (-6) moved
    to [-3, -0.5], which keeps every per-step decay of the smoke models at
    or above 0.35 (the range JAX's kernel tests draw; below it JAX's chunk
    form departs from the recurrence, ROADMAP.md queue 3 item 4); the mix
    factors (0.5) spread over [0.1, 0.9]; norms and biases 0.1 N(0, 1);
    weights 0.02 N(0, 1), as much again as their init."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "w0":
        return rs.uniform(3.0, 5.5, shape)
    if leaf in ("mu", "cm_mu"):
        return rs.uniform(-0.4, 0.4, shape)
    if leaf in ("scale", "bq", "bk", "bv"):
        return 0.1 * rs.randn(*shape)
    return 0.02 * rs.randn(*shape)


def perturbed(jcfg, cfg, seed=0):
    """(JAX params, the port's ParamTree): JAX's ``init_params`` from
    ``PRNGKey(seed)`` plus :func:`_noise` (numpy, ``seed``) on every leaf,
    in the leaf's dtype, loaded into both packages."""
    rs = np.random.RandomState(seed)

    def walk(tree, prefix=""):
        out = {}
        for key in sorted(tree):
            name = f"{prefix}{key}"
            if isinstance(tree[key], dict):
                out[key] = walk(tree[key], name + "/")
            else:
                a = np.asarray(tree[key])
                out[key] = (a.astype(np.float32)
                            + _noise(name, a.shape, rs)).astype(a.dtype)
        return out

    host = walk(jax.device_get(jax_init(jcfg, seed)))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = LM.init_params(cfg, generator=torch.Generator().manual_seed(seed))
    LM.load_params(tp, params_from_jax(host))
    return jp, tp


def tokens(cfg, S, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


_JAX_INIT = jax.jit(JLM.init_params, static_argnums=1)


def jax_init(jcfg, seed):
    """JAX's ``init_params`` from ``PRNGKey(seed)``, jitted once per config
    (eagerly each op compiles alone, which costs seconds)."""
    return _JAX_INIT(jax.random.PRNGKey(seed), jcfg)


def jax_decode(jcfg):
    return jax.jit(lambda p, t, c: JLM.decode_step(p, jcfg, t, c))


def jax_forward(jcfg, jp, toks, tgt):
    return jax.jit(lambda p, b: JLM.forward_train(p, jcfg, b)[0])(
        jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})


def jax_sublayer(jcfg, p, x, positions, cache, cache_index, window=0):
    """JAX's ``attention_sublayer`` on one layer's params, jitted."""
    return jax.jit(lambda p, x, pos, c: JLM.attention_sublayer(
        p, x, jcfg, pos, cache=c, cache_index=cache_index, window=window))(
            p, x, positions, cache)


def forward_matches_jax(arch, dtype):
    cfg, jcfg = configs(arch, dtype)
    jp, tp = perturbed(jcfg, cfg)
    toks = tokens(cfg, 20)
    tgt = np.roll(toks, -1, 1)
    want = jax_forward(jcfg, jp, toks, tgt)
    got = steps.make_prefill_step(cfg)(
        {"model": tp}, {"tokens": torch.from_numpy(toks),
                        "targets": torch.from_numpy(tgt)})
    assert got.shape == (B, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])


def greedy_serve_equals_jax(arch):
    """``lm_decode.serve`` with JAX's weights and prompt (both drawn from
    ``PRNGKey(seed)`` as JAX's ``serve`` draws them), in float32: 6 prompt
    + 10 generated tokens, token for token."""
    cfg, jcfg = configs(arch, "float32")
    seed, prompt_len, gen = 3, 6, 10
    tp = LM.init_params(cfg, generator=torch.Generator())
    LM.load_params(tp, params_from_jax(jax.device_get(jax_init(jcfg,
                                                                seed))))
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


def teacher_forcing_error(arch):
    """The bar of ``tests/test_models.py:80-100`` on the port alone (bf16,
    the config's own dtype): the largest gap between step-by-step decode
    log-probs and the scoring pass's."""
    cfg = get_config(arch, smoke=True)
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(cfg, 8, seed=2))
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
    return float(max(errs))


def cli_runs(arch, capsys):
    assert lm_decode.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3", "--gen", "4",
                           "--seed", "1"]) == 0
    assert "generated (2, 4) tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax(arch):
    """Each ported architecture's full and smoke configs, field for field,
    in JAX's registry order."""
    for smoke in (False, True):
        assert dataclasses.astuple(get_config(arch, smoke=smoke)) == \
            dataclasses.astuple(jax_registry.get_config(arch, smoke=smoke))
    assert ARCH_IDS == [a for a in jax_registry.ARCH_IDS if a in ARCH_IDS]


def test_registry_order_and_default_arch():
    """All ten ids in JAX's order, JAX's first (its LM entry point's
    default) first."""
    assert ARCH_IDS == jax_registry.ARCH_IDS == [
        "qwen2.5-32b", "command-r-plus-104b", "qwen2-72b", "command-r-35b",
        "hymba-1.5b", "rwkv6-1.6b", "whisper-medium", "qwen2-moe-a2.7b",
        "qwen3-moe-30b-a3b", "qwen2-vl-72b"]
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_params_have_jax_names_shapes_and_dtypes(arch):
    cfg, jcfg = configs(arch)
    flat = params_from_jax(jax.device_get(jax_init(jcfg, 0)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name
    assert ("layers/attn/bq" in own) == cfg.qkv_bias
    assert ("head" in own) == (not cfg.tie_embeddings)
    assert own["layers/mlp/wi_gate"].shape == (2, 64, 128)


def test_sliced_draws_fill_every_layer(monkeypatch):
    """The layer-by-layer draw: a leaf of the dtype, every slice filled
    with std 0.02 draws, also when a draw takes several ragged rows."""
    from repro_torch.nn import core
    g = torch.Generator().manual_seed(0)
    x = core.normal_init_sliced((5, 300, 7), generator=g,
                                device=torch.device("cpu"),
                                dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.shape == (5, 300, 7)
    assert all(float(x[i].float().std()) > 0.015 for i in range(5))
    assert abs(float(x.float().std()) - 0.02) < 1e-3
    monkeypatch.setattr(core, "SLICE_ELEMENTS", 1000)   # 3 rows a draw
    y = core.normal_init_sliced((5, 300, 7), generator=g,
                                device=torch.device("cpu"))
    assert bool((y != 0).all())
    assert abs(float(y.std()) - 0.02) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_train_matches_jax(arch, dtype):
    """20 tokens scored through the causal flash attention (its plain
    version here) and the chunked head."""
    forward_matches_jax(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_steps_match_jax(arch, dtype):
    """10 decode steps, each token's logits against JAX's, and the cache's
    K/V and stored positions after them (``_decode_attention`` over a
    16-slot cache)."""
    cfg, jcfg = configs(arch, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=1)
    toks = tokens(cfg, 10, seed=1)
    jstep = jax_decode(jcfg)
    jc = JLM.init_cache(jcfg, B, 16)
    tc = LM.init_cache(cfg, B, 16)
    assert tc["kv"]["k"].shape == (2, B, 16, 2, 16)
    serve = steps.make_serve_step(cfg)
    for t in range(10):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        nxt, tl, tc = serve({"model": tp}, torch.from_numpy(toks[:, t:t + 1]),
                            tc)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
        assert torch.equal(nxt, torch.argmax(tl, -1).to(torch.int32))
        assert tc["index"] == int(jc["index"]) == t + 1
    np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                  np.asarray(jc["kv"]["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc["kv"][name]),
                                   np32(jc["kv"][name]), atol=TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
def test_dense_greedy_serve_tokens_equal_jax(arch):
    greedy_serve_equals_jax(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_matches_teacher_forcing(arch):
    assert teacher_forcing_error(arch) < 0.05


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "command-r-35b",
                                  "qwen2-72b", "command-r-plus-104b"])
def test_dense_cli_on_the_cpu(arch, capsys):
    cli_runs(arch, capsys)
