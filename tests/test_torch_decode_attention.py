"""The port's decode attention against the JAX package's.

The port's plain version (``repro_torch.kernels.ref.ref_decode_attention``,
what ``ops.decode_attention`` runs on a CPU tensor) is held against the
Pallas kernel in interpret mode and against ``repro.kernels.ref`` on the
sweep of ``tests/test_fused_step.py::TestDecodeAttentionEdges`` (S < 8, S
not a multiple of the block, ``kv_valid == 0`` rows that must be exact
zeros) and at the training rollout's shape.  Inputs are drawn with numpy
from a seed.  Tolerance 1e-5: fp32 on both sides, other reduction orders.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.ref import ref_decode_attention as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_decode_attention  # noqa: E402
from repro_torch.nn.transformer import _single_query_attention  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, D).astype(np.float32),
            rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, H, D).astype(np.float32))


def _port(q, k, v, kv_valid):
    return ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.asarray(kv_valid, np.int32))).numpy()


@pytest.mark.parametrize("S,block_k", [(5, 128), (13, 8), (7, 16),
                                       (100, 128)])
def test_matches_pallas_and_jax_ref_with_empty_rows(S, block_k):
    q, k, v = _inputs(3, S, 2, 8, seed=S)
    kv_valid = np.array([0, 1, S], np.int32)
    got = _port(q, k, v, kv_valid)
    want = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_valid), block_k=block_k, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(kv_valid))),
        **TOL)
    assert np.all(got[0] == 0.0)


def test_training_rollout_shape():
    """q (16, 8, 8) against a (16, 16, 8, 8) cache, kv_valid 1..16."""
    q, k, v = _inputs(16, 16, 8, 8, seed=0)
    kv_valid = np.arange(1, 17, dtype=np.int32)
    got = _port(q, k, v, kv_valid)
    want = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_valid), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_kv_valid_beyond_capacity_attends_every_slot():
    q, k, v = _inputs(2, 6, 2, 4, seed=3)
    np.testing.assert_allclose(_port(q, k, v, [9, 6]),
                               _port(q, k, v, [6, 6]), **TOL)


def test_equals_the_cached_query_path():
    """``encoder_query_cached`` calls the kernel with ``kv_valid = lengths
    + 1``; on the CPU it masks slots ``0..lengths``: the two agree."""
    q, k, v = _inputs(5, 9, 3, 8, seed=4)
    lengths = np.array([0, 3, 7, 8, 2], np.int32)
    valid = (torch.arange(9)[None, :]
             <= torch.from_numpy(lengths)[:, None])
    plain = _single_query_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), valid)
    np.testing.assert_allclose(_port(q, k, v, lengths + 1), plain.numpy(),
                               **TOL)


def test_refuses_operands_that_require_grad():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 4, seed=1))
    kv_valid = torch.tensor([1, 4], dtype=torch.int32)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, k, v, kv_valid)
    with torch.no_grad():
        out = ops.decode_attention(q, k, v, kv_valid)
    torch.testing.assert_close(out, ref_decode_attention(q.detach(), k, v,
                                                         kv_valid))


def test_rejects_bad_operands():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 4, seed=2))
    with pytest.raises(TypeError, match="kv_valid"):
        ops.decode_attention(q, k, v, torch.tensor([1, 4]))      # int64
    with pytest.raises(ValueError, match="do not agree"):
        ops.decode_attention(q, k[:, :, :1], v,
                             torch.tensor([1, 4], dtype=torch.int32))
