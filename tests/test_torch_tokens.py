"""The port's synthetic token data (``repro_torch.data.tokens``) against
the JAX package's ``repro.data.tokens``: every tensor of
``synthetic_gfn_batch`` bitwise JAX's, for a token family, the VLM
(embeddings and M-RoPE ids in place of tokens) and Whisper (frames), and
``token_stream``'s order."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import tokens  # noqa: E402

torch.set_num_threads(2)


def _bits(x):
    """A tensor or JAX array as comparable numpy bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(jax.device_get(x))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-vl-72b",
                                  "whisper-medium", "rwkv6-1.6b"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17)])
def test_synthetic_gfn_batch_is_bitwise_jax(arch, seed, step):
    cfg = get_config(arch, smoke=True)
    jcfg = jax_registry.get_config(arch, smoke=True)
    got = tokens.synthetic_gfn_batch(cfg, 3, 20, seed=seed, step=step,
                                     device=torch.device("cpu"))
    want = jax_tokens.synthetic_gfn_batch(jcfg, 3, 20, seed=seed, step=step)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
    if cfg.family == "vlm":
        assert "tokens" not in got and got["embeds"].dtype == torch.bfloat16


def test_token_stream_follows_jax():
    cfg = get_config("hymba-1.5b", smoke=True)
    jcfg = jax_registry.get_config("hymba-1.5b", smoke=True)
    ours = tokens.token_stream(cfg, 2, 8, seed=5, start_step=4)
    theirs = jax_tokens.token_stream(jcfg, 2, 8, seed=5, start_step=4)
    for (s, b), (js, jb) in itertools.islice(zip(ours, theirs), 3):
        assert s == js
        assert np.array_equal(_bits(b["tokens"]), _bits(jb["tokens"]))
