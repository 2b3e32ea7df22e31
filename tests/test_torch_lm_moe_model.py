"""The port's MoE models against the JAX package's: the scoring pass with
its aux loss, decode steps at batch 8 (capacity 1) through
``make_serve_step`` and greedy ``lm_decode.serve``.  Smoke configs with
perturbed parameters; tolerances 1e-5 in float32, 5e-2 in bfloat16 (the
routing itself: ``tests/test_torch_lm_moe.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm_dense import (  # noqa: E402
    TOL, configs, greedy_serve_equals_jax, np32, perturbed)
from test_torch_lm_moe import MOE  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_train_matches_jax(arch, dtype):
    """20 tokens scored (one group of 40): log-probs and the aux loss
    summed over the layers."""
    cfg, jcfg = configs(arch, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=5)
    toks = np.random.RandomState(6).randint(0, 256, (2, 20)).astype(np.int32)
    tgt = np.roll(toks, -1, 1)
    want, jaux = jax.jit(lambda p, b: JLM.forward_train(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    got, aux = LM.forward_train(tp, cfg, {"tokens": torch.from_numpy(toks),
                                          "targets": torch.from_numpy(tgt)})
    np.testing.assert_allclose(np32(got), np32(want), atol=TOL[dtype])
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_steps_match_jax(arch, dtype):
    """4 decode steps at batch 8 through ``make_serve_step`` (8 tokens a
    step, capacity 1: most (token, slot) pairs are dropped, as in JAX):
    logits, next tokens and the cache."""
    cfg, jcfg = configs(arch, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=7)
    toks = np.random.RandomState(8).randint(0, 256, (8, 4)).astype(np.int32)
    jserve = jax.jit(lambda p, t, c: jax_steps.make_serve_step(jcfg)(
        {"model": p}, t, c, {}))
    serve = steps.make_serve_step(cfg)
    jc, tc = JLM.init_cache(jcfg, 8, 8), LM.init_cache(cfg, 8, 8)
    for t in range(4):
        jn, jl, jc = jserve(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tn, tl, tc = serve({"model": tp}, torch.from_numpy(toks[:, t:t + 1]),
                           tc)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=f"step {t}")
        if dtype == "float32":
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tc["index"] == int(jc["index"]) == 4
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc["kv"][name]),
                                   np32(jc["kv"][name]), atol=TOL[dtype])



@pytest.mark.parametrize("arch", MOE)
def test_moe_greedy_serve_tokens_equal_jax(arch):
    greedy_serve_equals_jax(arch)
