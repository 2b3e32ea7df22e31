"""The port's MoE family (qwen2-moe-a2.7b: 60 experts padded to 64 plus
shared experts; qwen3-moe-30b-a3b: 128 experts, top-8) against the JAX
package's.

Smoke configs (2 layers, d_model 64; 6 and 8 experts, both padded to 16,
top-2) with perturbed parameters (``tests/test_torch_lm_dense.py``'s
helpers); tolerances as there: 1e-5 in float32, 5e-2 in bfloat16.  The
routing is compared first and exactly: each token's experts, each (token,
slot)'s queue position and whether it fits the capacity, against the
reference's own lines (``src/repro/models/moe.py:72-94``, restated in
:func:`jax_route` since ``moe_mlp`` returns only the output and the aux
loss), with the group shrunk so that there are several groups and tokens
are dropped.  At decode with batch 8 the capacity is 1 (``int(0.625)``
at full width, ``int(1.25)`` here): each expert takes one (token, slot).
The whole model (scoring, decode, serving):
``tests/test_torch_lm_moe_model.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_lm_dense import (TOL, configs, jax_init, np32,  # noqa: E402
                                 perturbed)

torch.set_num_threads(2)

MOE = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


def jax_route(p, x, jcfg, group_size, mlp=False):
    """The reference's routing of x (T, d), its lines restated: router
    probabilities, top-k experts, renormalized gates, token-major queue
    positions within each group of min(group_size, T) tokens, and the
    capacity mask; with ``mlp`` also ``moe_mlp``'s (out, aux) on x
    reshaped to (1, T, d).  One jitted call (eagerly each op compiles
    alone)."""
    T = x.shape[0]
    k, E = jcfg.num_experts_per_tok, JMOE.padded_num_experts(jcfg)
    Tg = min(group_size, T)
    G = T // Tg
    C = max(int(k * Tg / E * jcfg.capacity_factor), 1)

    @jax.jit
    def route(p, x):
        probs = JMOE._router_probs(p, x, jcfg)
        top_idx = jax.lax.top_k(probs, k)[1]
        gates = jnp.take_along_axis(probs, top_idx, axis=-1)
        gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
        onehot = jax.nn.one_hot(top_idx.reshape(G, Tg, k), E,
                                dtype=jnp.float32)
        flat = onehot.reshape(G, Tg * k, E)
        pos = jnp.cumsum(flat, axis=1) - flat
        pos = jnp.sum(pos.reshape(G, Tg, k, E) * onehot, axis=-1)
        out = (JMOE.moe_mlp(p, x[None], jcfg, group_size) if mlp
               else None)
        return probs, top_idx, gates, pos, out

    probs, top_idx, gates, pos, out = route(p, x)
    return {"probs": np.asarray(probs), "experts": np.asarray(top_idx),
            "gates": np.asarray(gates),
            "position": np.asarray(pos).reshape(T, k).astype(np.int64),
            "keep": np.asarray(pos < C).reshape(T, k), "capacity": C,
            "mlp": out}


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            LM._layer(tp["layers"], 0))


def _x(cfg, shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, jdt), torch.from_numpy(
        np.array(np32(jnp.asarray(x, jdt)))).to(LM._dtype(cfg))


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_have_jax_names_shapes_and_dtypes(arch):
    """The router in float32 in a bf16 model, the experts padded, the
    shared experts and their gate in the model's dtype (qwen2-moe only)."""
    cfg, jcfg = configs(arch)
    flat = params_from_jax(jax.device_get(jax_init(jcfg, 0)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name
    assert own["layers/router"].dtype == torch.float32
    assert own["layers/we_gate"].shape == (2, 16, 64, 32)
    assert ("layers/shared_gate" in own) == bool(cfg.shared_d_ff)
    if cfg.shared_d_ff:
        assert own["layers/shared_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_mlp_routes_and_drops_as_jax(arch, dtype):
    """32 tokens in 4 groups of 8 (capacity 1): the experts, queue
    positions and kept mask equal JAX's, then the gates, the aux loss and
    the output (the dropped pairs contribute nothing; the shared experts
    everywhere); the pad experts get no token."""
    cfg, jcfg = configs(arch, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=1)
    jl, tl = _layer0(jp, tp)
    jx, tx = _x(cfg, (2, 16, cfg.d_model), seed=2)
    want = jax_route(jl, jx.reshape(32, -1), jcfg, 8, mlp=True)
    got = moe.moe_route(tl, tx.reshape(32, -1), cfg, 8)
    assert (got["groups"], got["group_tokens"], got["capacity"]) == \
        (4, 8, want["capacity"]) == (4, 8, 1)
    np.testing.assert_array_equal(got["experts"].numpy(), want["experts"])
    np.testing.assert_array_equal(got["position"].numpy(), want["position"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    assert 0 < int(got["keep"].sum()) < got["keep"].numel()
    assert int(got["experts"].max()) < cfg.num_experts
    np.testing.assert_allclose(got["gates"].numpy(), want["gates"],
                               atol=1e-6)
    jout, jaux = want["mlp"]
    out, aux = moe.moe_mlp(tl, tx, cfg, 8)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(np32(out), np32(jout).reshape(out.shape),
                               atol=TOL[dtype])


def test_queue_positions_match_jax_at_scale():
    """2,048 tokens in 4 groups of 512 (capacity 80), the router scaled
    tenfold so that a few experts draw most pairs: every queue position
    and kept mask equal the reference's cumsum over its one-hot tensor."""
    cfg, jcfg = configs("qwen3-moe-30b-a3b", "float32")
    jp, tp = perturbed(jcfg, cfg, seed=11)
    jl, tl = _layer0(jp, tp)
    with torch.no_grad():
        tl["router"].mul_(10.0)
    jl = dict(jl, router=jnp.asarray(tl["router"].numpy()))
    jx, tx = _x(cfg, (2048, cfg.d_model), seed=12)
    want = jax_route(jl, jx, jcfg, 512)
    got = moe.moe_route(tl, tx, cfg, 512)
    assert (got["groups"], got["capacity"]) == (4, want["capacity"]) == \
        (4, 80)
    np.testing.assert_array_equal(got["experts"].numpy(), want["experts"])
    np.testing.assert_array_equal(got["position"].numpy(), want["position"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    assert 0.05 < 1 - float(got["keep"].float().mean()) < 0.95


def test_tied_experts_go_to_the_lower_index_as_in_jax():
    """Every real expert's router column the same: all eight tie on every
    token, and ``jax.lax.top_k`` takes experts 0 and 1; so does the
    port's stable sort."""
    cfg, jcfg = configs("qwen3-moe-30b-a3b", "float32")
    jp, tp = perturbed(jcfg, cfg, seed=13)
    jl, tl = _layer0(jp, tp)
    with torch.no_grad():
        tl["router"][:, :cfg.num_experts] = tl["router"][:, :1]
    jl = dict(jl, router=jnp.asarray(tl["router"].numpy()))
    jx, tx = _x(cfg, (16, cfg.d_model), seed=14)
    want = jax_route(jl, jx, jcfg, 512)
    got = moe.moe_route(tl, tx, cfg, 512)
    assert (want["experts"] == [0, 1]).all()
    np.testing.assert_array_equal(got["experts"].numpy(), want["experts"])


@pytest.mark.parametrize("arch", MOE)
def test_pad_experts_get_no_token(arch):
    """Pad experts (6 -> 16, 8 -> 16) have probability 0 in both packages
    and are never chosen, whatever the router's weights there."""
    cfg, jcfg = configs(arch, "float32")
    jp, tp = perturbed(jcfg, cfg, seed=3)
    jl, tl = _layer0(jp, tp)
    with torch.no_grad():
        tl["router"][:, cfg.num_experts:] = 10.0
    jl = dict(jl, router=jnp.asarray(tl["router"].numpy()))
    jx, tx = _x(cfg, (64, cfg.d_model), seed=4)
    want = jax_route(jl, jx, jcfg, 512)
    probs = moe._router_probs(tl, tx, cfg)
    np.testing.assert_allclose(probs.numpy(), want["probs"], atol=1e-6)
    assert float(probs[:, cfg.num_experts:].abs().max()) == 0.0
    r = moe.moe_route(tl, tx, cfg, 512)
    assert int(r["experts"].max()) < cfg.num_experts
    np.testing.assert_array_equal(r["experts"].numpy(), want["experts"])


def test_decode_capacity_is_one_at_batch_8():
    """At full width both configs give each expert one (token, slot) a
    decode step of batch 8: int(4 * 8 / 64 * 1.25) = int(8 * 8 / 128 *
    1.25) = 0, raised to 1."""
    for arch in MOE:
        cfg = get_config(arch)
        p = {"router": torch.zeros(cfg.d_model, cfg.padded_experts)}
        r = moe.moe_route(p, torch.randn(8, cfg.d_model), cfg,
                          cfg.moe_group_size)
        assert (r["groups"], r["capacity"]) == (1, 1)
        assert int(r["keep"].sum()) <= cfg.num_experts


def test_tokens_off_the_group_raise_as_in_jax():
    """20 tokens in groups of 8: JAX's reshape into groups fails; the port
    raises ValueError rather than pad."""
    cfg, jcfg = configs("qwen3-moe-30b-a3b", "float32")
    jp, tp = perturbed(jcfg, cfg, seed=9)
    jl, tl = _layer0(jp, tp)
    jx, tx = _x(cfg, (2, 10, cfg.d_model), seed=10)
    with pytest.raises(TypeError):
        JMOE.moe_mlp(jl, jx, jcfg, 8)
    with pytest.raises(ValueError, match="groups of 8"):
        moe.moe_mlp(tl, tx, cfg, 8)
    small = dataclasses.replace(cfg, moe_group_size=8)
    toks = torch.zeros(2, 10, dtype=torch.int64)
    with pytest.raises(ValueError, match="groups of 8"):
        LM.forward_train(tp, small, {"tokens": toks, "targets": toks})
