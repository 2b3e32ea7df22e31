"""The port's VLM family (qwen2-vl: the dense block with M-RoPE, embeddings
in) against the JAX package's.

Smoke config (2 layers, d_model 64, 4/2 heads of 16, M-RoPE sections (2,
3, 3)) with perturbed parameters (``tests/test_torch_lm_dense.py``'s
helpers); tolerances as there: 1e-5 in float32, 5e-2 in bfloat16.  The
embeddings are seeded numpy draws (the vision frontend is a stub in both
packages).  Every position id here has t, h and w apart (with all three
equal M-RoPE is RoPE, ``tests/test_models.py:144``): text tokens, then an
image grid at one t with h / w its row and column, then text resuming at
the largest so far + 1, as qwen2-vl numbers them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import lm_decode, steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm_dense import (B, TOL, configs, jax_init, np32,  # noqa: E402
                                 perturbed)

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"


def grid_positions(text, grid, after):
    """(3, S) int32 M-RoPE ids: ``text`` tokens at t = h = w = 0, 1, ...;
    an image of ``grid`` = (rows, cols) patches at t = the next index, h
    and w that index plus the patch's row and column; ``after`` text tokens
    from the largest id so far + 1."""
    ids = [np.arange(text)] * 3
    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    ids = [np.concatenate([a, text + b]) for a, b in
           zip(ids, (np.zeros(rows * cols, int), r, c))]
    start = max(int(a.max()) for a in ids) + 1
    return np.stack([np.concatenate([a, start + np.arange(after)])
                     for a in ids]).astype(np.int32)


def vlm_inputs(cfg, text=4, grid=(3, 4), after=4, seed=0):
    """Seeded embeddings (B, S, d) in the config's dtype as numpy float32
    and (3, B, S) position ids."""
    pos = grid_positions(text, grid, after)
    S = pos.shape[1]
    emb = np.random.RandomState(seed).randn(B, S, cfg.d_model)
    jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    emb = np32(jnp.asarray(emb, jdt))               # rounded to the dtype
    return emb, np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                     (3, B, S)))


def _t(a, cfg=None):
    t = torch.from_numpy(np.array(a))
    return t.to(LM._dtype(cfg)) if cfg is not None else t


def _j(a, jcfg):
    return jnp.asarray(a, jnp.bfloat16 if jcfg.dtype == "bfloat16"
                       else jnp.float32)


def test_grid_positions_keep_t_h_w_apart():
    pos = grid_positions(2, (2, 3), 2)
    assert pos.tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6],
                            [0, 1, 2, 2, 2, 3, 3, 3, 5, 6],
                            [0, 1, 2, 3, 4, 2, 3, 4, 5, 6]]


@pytest.mark.parametrize("D,sections", [(16, (2, 3, 3)), (128, (16, 24, 24)),
                                        (16, (1, 2, 2)), (16, (4, 4, 4))])
def test_apply_mrope_matches_jax(D, sections):
    """Bands by ``sections`` (also a split that falls short of D/2, whose
    last section runs on, and one past it, which is cut), interleaved
    pairs; not RoPE of any one component (theta 100, so that every band
    turns by a visible angle)."""
    rs = np.random.RandomState(D + sum(sections))
    x = rs.randn(B, 10, 3, D).astype(np.float32)
    pos = np.stack([grid_positions(2, (2, 3), 2)] * B, axis=1)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 100.0,
                                  sections)
    got = layers.apply_mrope(_t(x), _t(pos), 100.0, sections)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)
    for i in range(3):
        rope = layers.apply_rope(_t(x), _t(pos[i]), 100.0)
        assert float((rope - got).abs().max()) > 1e-2


def test_vlm_params_have_jax_names_shapes_and_dtypes():
    cfg, jcfg = configs(ARCH)
    flat = params_from_jax(jax.device_get(jax_init(jcfg, 0)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_train_matches_jax(dtype):
    """20 positions (4 text, a 3 x 4 grid, 4 text) scored through
    ``make_prefill_step`` from embeddings; the aux loss is 0."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg)
    emb, pos = vlm_inputs(cfg)
    tgt = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           emb.shape[:2]).astype(np.int32)
    want, jaux = jax.jit(lambda p, b: JLM.forward_train(p, jcfg, b))(
        jp, {"embeds": _j(emb, jcfg), "position_ids": jnp.asarray(pos),
             "targets": jnp.asarray(tgt)})
    batch = {"embeds": _t(emb, cfg), "position_ids": _t(pos),
             "targets": _t(tgt)}
    got = steps.make_prefill_step(cfg)({"model": tp}, batch)
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])
    _, aux = LM.forward_train(tp, cfg, batch)
    assert float(aux) == float(jaux) == 0.0


def _jax_serve(jcfg):
    return jax.jit(lambda p, t, c, e: jax_steps.make_serve_step(jcfg)(
        {"model": p}, t, c, e))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_serve_steps_match_jax(dtype):
    """4 decode steps through ``make_serve_step`` with the embeddings and
    position ids as ``extra`` (2 text, a 1 x 2 grid: distinct t / h / w):
    logits, next tokens and the cache against JAX's; the cache stores the
    temporal component."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=2)
    emb, pos = vlm_inputs(cfg, text=2, grid=(1, 2), after=0, seed=3)
    jserve, serve = _jax_serve(jcfg), steps.make_serve_step(cfg)
    jc, tc = JLM.init_cache(jcfg, B, 8), LM.init_cache(cfg, B, 8)
    tok = np.zeros((B, 1), np.int32)
    for t in range(4):
        je = {"embeds": _j(emb[:, t:t + 1], jcfg),
              "position_ids": jnp.asarray(pos[:, :, t:t + 1])}
        te = {"embeds": _t(emb[:, t:t + 1], cfg),
              "position_ids": _t(pos[:, :, t:t + 1])}
        jn, jl, jc = jserve(jp, jnp.asarray(tok), jc, je)
        tn, tl, tc = serve({"model": tp}, _t(tok), tc, te)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
        assert torch.equal(tn, torch.argmax(tl, -1).to(torch.int32))
    assert tc["index"] == int(jc["index"]) == 4
    np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                  np.asarray(jc["kv"]["pos"]))
    assert tc["kv"]["pos"][0, 0, :4].tolist() == [0, 1, 2, 2]
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc["kv"][name]),
                                   np32(jc["kv"][name]), atol=TOL[dtype])


def test_vlm_fused_decode_refeeds_its_extras_as_jax():
    """ROADMAP.md queue 3, reference item 13: with ``decode_steps=2`` JAX's
    VLM serve step feeds the same embeddings and position ids to both
    steps (its ``lax.scan`` body closes over ``extra``; the chosen token
    is not read) while the index advances, so the two cache slots hold
    the same temporal position.  The port's fused call does the same: it
    equals JAX's and two single steps with the same extras, float32."""
    cfg, jcfg = configs(ARCH, "float32", decode_steps=2)
    jp, tp = perturbed(jcfg, cfg, seed=4)
    emb, pos = vlm_inputs(cfg, text=0, grid=(1, 1), after=0, seed=5)
    pos = pos + 3
    je = {"embeds": _j(emb, jcfg), "position_ids": jnp.asarray(pos)}
    te = {"embeds": _t(emb, cfg), "position_ids": _t(pos)}
    tok = np.zeros((B, 1), np.int32)
    jn, jl, jc = _jax_serve(jcfg)(jp, jnp.asarray(tok),
                                  JLM.init_cache(jcfg, B, 4), je)
    assert int(jc["index"]) == 2
    assert np.asarray(jc["kv"]["pos"])[:, :, :2].tolist() == \
        [[[3, 3]] * B] * 2
    tn, tl, tc = steps.make_serve_step(cfg)({"model": tp}, _t(tok),
                                            LM.init_cache(cfg, B, 4), te)
    np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL["float32"])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                  np.asarray(jc["kv"]["pos"]))
    one = steps.make_serve_step(dataclasses.replace(cfg, decode_steps=1))
    c1 = LM.init_cache(cfg, B, 4)
    for _ in range(2):
        n1, l1, c1 = one({"model": tp}, _t(tok), c1, te)
    assert torch.equal(l1, tl) and torch.equal(n1, tn)


def test_vlm_entry_points_refuse_what_they_cannot_read():
    """``lm_decode.serve`` raises for the VLM (JAX's ``serve`` hands its
    decode step no embeddings and fails there), as does a decode step
    without them; the other families refuse serve-step extras."""
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="make_serve_step"):
        lm_decode.serve(cfg, batch=B, prompt_len=2, gen=2, device="cpu")
    params = LM.init_params(cfg, generator=torch.Generator())
    tok = torch.zeros(B, 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="position_ids"):
        LM.decode_step(params, cfg, tok, LM.init_cache(cfg, B, 4))
    dense = get_config("qwen2.5-32b", smoke=True)
    dp = LM.init_params(dense, generator=torch.Generator())
    with pytest.raises(ValueError, match="VLM's"):
        steps.make_serve_step(dense)({"model": dp}, tok,
                                     LM.init_cache(dense, B, 4),
                                     {"embeds": dp["embed"][tok]})
