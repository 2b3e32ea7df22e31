"""The port's RWKV6 family (rwkv6-1.6b) against the JAX package's.

The smoke config (2 layers, d_model 64, 4 heads of 16, d_ff 128, vocab
256) with perturbed parameters (``tests/test_torch_lm_dense.py``'s
:func:`perturbed`: the token-shift mixes spread over [0.1, 0.9], the decay
base moved to [-3, -0.5]), loaded into both packages.  The scan runs its
plain step recurrence here; JAX's model runs its chunk form, which equals
the recurrence while every per-step decay stays at or above 0.35 (the
range JAX's kernel tests draw: ``ROADMAP.md`` queue 3 item 4), and each
test that compares with JAX checks that the decays it ran stayed there.
Tolerances: 1e-5 in float32, 5e-2 in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as JLM  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm_dense import (B, TOL, cli_runs, configs,  # noqa: E402
                                 forward_matches_jax, greedy_serve_equals_jax,
                                 jax_decode, jax_init, np32, perturbed,
                                 teacher_forcing_error, tokens)

torch.set_num_threads(2)

ARCH = "rwkv6-1.6b"
#: the smallest per-step decay JAX's chunk form is held at (queue 3 item 4)
MIN_DECAY = 0.35


@pytest.fixture
def decays(monkeypatch):
    """The smallest decay each call of the model's scan saw."""
    seen = []
    real = LM.chunked_linear_attention

    def recording(r, k, v, w, u=None, state=None):
        seen.append(float(w.min()))
        return real(r, k, v, w, u, state)

    monkeypatch.setattr(LM, "chunked_linear_attention", recording)
    return seen


def test_rwkv_params_have_jax_names_shapes_dtypes_and_values():
    """JAX's leaves, and its initial values where they are not drawn: the
    mixes at 0.5, ``w0`` at -6, the norms at 1."""
    cfg, jcfg = configs(ARCH)
    flat = params_from_jax(jax.device_get(jax_init(jcfg, 0)))
    own = LM.init_params(cfg, generator=torch.Generator().manual_seed(0)
                         ).flat()
    assert sorted(own) == sorted(flat)
    for name, t in own.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat[name].shape),
                                              flat[name].dtype), name
        if not name.endswith(("w0", "mu", "scale")):
            continue
        assert torch.equal(t, flat[name]), name
    assert own["layers/mu"].shape == (2, 5, 64)
    assert own["layers/bonus_u"].shape == (2, 4, 16)
    assert own["layers/w_lora_a"].shape == (2, 64, LM.RWKV_LORA)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_forward_train_matches_jax(dtype, decays):
    """20 tokens scored: the token shift, five mixes, the LoRA decay in
    float32, the scan with its bonus, ``ln_x`` times the gate, the channel
    mix."""
    forward_matches_jax(ARCH, dtype)
    assert len(decays) == 2 and min(decays) >= MIN_DECAY


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_decode_steps_and_state_match_jax(dtype, decays):
    """10 decode steps: each step's logits and, after it, the token shifts
    ``shift`` / ``cm_shift`` and the wkv state against JAX's."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = perturbed(jcfg, cfg, seed=1)
    toks = tokens(cfg, 10, seed=1)
    jstep = jax_decode(jcfg)
    jc = JLM.init_cache(jcfg, B, 16)
    tc = LM.init_cache(cfg, B, 16)
    assert tc["wkv"].shape == (2, B, 4, 16, 16)
    assert tc["wkv"].dtype == torch.float32
    assert tc["shift"].dtype == LM._dtype(cfg)
    for t in range(10):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = LM.decode_step(tp, cfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc)
        msg = f"step {t}"
        np.testing.assert_allclose(np32(tl), np32(jl), atol=TOL[dtype],
                                   err_msg=msg)
        for name in ("shift", "cm_shift", "wkv"):
            np.testing.assert_allclose(np32(tc[name]), np32(jc[name]),
                                       atol=TOL[dtype], rtol=TOL[dtype],
                                       err_msg=f"{msg}: {name}")
        assert tc["index"] == int(jc["index"]) == t + 1
    assert len(decays) == 20 and min(decays) >= MIN_DECAY


def test_rwkv_greedy_serve_tokens_equal_jax():
    greedy_serve_equals_jax(ARCH)


def test_rwkv_decode_matches_teacher_forcing():
    assert teacher_forcing_error(ARCH) < 0.05


def test_rwkv_cli_on_the_cpu(capsys):
    cli_runs(ARCH, capsys)
