"""Whisper's ``lm_decode.serve`` against the JAX package's ``serve``.

JAX's ``serve`` runs a float32 Whisper only unrolled (``scan_layers=
False``): it draws its frames in bfloat16, and the encoder's scan carry
turns float32 after the first layer, which ``lax.scan`` refuses; the
port promotes those frames as JAX's unrolled layers do
(``models/lm.py`` ``_project_qkv``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import lm_decode as jax_lm_decode  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import lm_decode  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from test_torch_lm import _jax_gumbel_draws  # noqa: E402
from test_torch_lm_dense import B, configs, jax_init, np32  # noqa: E402

torch.set_num_threads(2)

ARCH = "whisper-medium"


def test_sampled_serve_tokens_equal_jax():
    """``lm_decode.serve`` against JAX's ``serve`` (float32, unrolled):
    JAX's weights, prompt and bfloat16 frames (drawn from ``PRNGKey(seed)``
    as its ``serve`` draws them; the cross cache over ``prompt_len``
    frames) and its replayed Gumbel draws: 6 prompt + 8 sampled tokens,
    token for token."""
    cfg, jcfg = configs(ARCH, "float32", scan_layers=False)
    seed, prompt_len, gen = 3, 6, 8
    key = jax.random.PRNGKey(seed)
    tp = LM.init_params(cfg, generator=torch.Generator())
    LM.load_params(tp, params_from_jax(jax.device_get(jax_init(jcfg,
                                                                seed))))
    prompt = jax.random.randint(key, (B, prompt_len), 0, cfg.vocab_size)
    jframes = jax.random.normal(key, (B, prompt_len, cfg.d_model),
                                jnp.bfloat16)
    want, _ = jax_lm_decode.serve(jcfg, batch=B, prompt_len=prompt_len,
                                  gen=gen, seed=seed, greedy=False)
    got, _ = lm_decode.serve(
        cfg, batch=B, prompt_len=prompt_len, gen=gen, seed=seed,
        device="cpu", params=tp, prompt=torch.from_numpy(np.array(prompt)),
        noise=torch.from_numpy(_jax_gumbel_draws(seed, gen,
                                                 (B, cfg.vocab_size))),
        frames=torch.from_numpy(np.array(np32(jframes))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
