"""The port's trajectory log-probability against the JAX package's.

Forward: the port's plain version (``ops.traj_logprob`` on CPU tensors) is
held against the Pallas kernel in interpret mode and against
``repro.kernels.ref.ref_traj_logprob``, on inputs drawn with numpy from a
seed, including dead steps (``valid`` False), masked actions, and the
training path's transposed (B, T, A) views of time-major logits.
Backward: the autograd gradient with both cotangents (``total`` and
``per_step``) against ``jax.grad`` of ``repro.kernels.ops.traj_logprob``
(its closed-form VJP).  Tolerance 1e-5 (fp32, other reduction orders).
The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import traj_logprob as jax_traj_logprob  # noqa: E402
from repro.kernels.ref import ref_traj_logprob as jax_ref  # noqa: E402
from repro.kernels.traj_logprob import traj_logprob_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (ref_traj_logprob,  # noqa: E402
                                     ref_traj_logprob_backward)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(3, 5, 7), (16, 15, 15), (2, 9, 203), (4, 15, 3840)]


def _inputs(B, T, A, seed):
    """Logits, legal mask (the taken action always legal), actions and a
    valid prefix per row, as numpy."""
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(B, T, A)).astype(np.float32)
    mask = rng.rand(B, T, A) < 0.6
    actions = rng.randint(0, A, size=(B, T))
    mask[np.arange(B)[:, None], np.arange(T)[None, :], actions] = True
    valid = np.arange(T)[None, :] < rng.randint(1, T + 1, size=(B, 1))
    return logits, mask, actions, valid


def _torch(logits, mask, actions, valid):
    return (torch.from_numpy(logits), torch.from_numpy(actions),
            torch.from_numpy(mask), torch.from_numpy(valid))


@pytest.mark.parametrize("B,T,A", SHAPES)
def test_forward_matches_pallas_and_jax_ref(B, T, A):
    logits, mask, actions, valid = _inputs(B, T, A, seed=A)
    total, per_step = ops.traj_logprob(*_torch(logits, mask, actions, valid))
    jargs = (jnp.asarray(logits), jnp.asarray(actions), jnp.asarray(mask),
             jnp.asarray(valid))
    for want in (traj_logprob_pallas(*jargs, interpret=True),
                 jax_ref(*jargs)):
        np.testing.assert_allclose(total.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(per_step.numpy(), np.asarray(want[1]),
                                   **TOL)
    assert np.all(per_step.numpy()[~valid] == 0.0)


def test_time_major_views_equal_contiguous_inputs():
    """The training path hands over ``x[:-1].transpose(0, 1)`` of (T+1, B,
    A) tensors; the result equals that of contiguous copies."""
    logits, mask, actions, valid = _inputs(5, 6, 40, seed=1)
    tm = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.concatenate([np.swapaxes(x, 0, 1), np.swapaxes(x, 0, 1)[:1]])))
    views = (tm(logits)[:-1].transpose(0, 1),
             torch.from_numpy(np.ascontiguousarray(actions.T)).T,
             tm(mask)[:-1].transpose(0, 1),
             torch.from_numpy(np.ascontiguousarray(valid.T)).T)
    assert not views[0].is_contiguous()
    got = ops.traj_logprob(*views)
    want = ops.traj_logprob(*_torch(logits, mask, actions, valid))
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], **TOL)   # sum order


@pytest.mark.parametrize("B,T,A", SHAPES[:3])
def test_gradient_matches_jax_closed_form_vjp(B, T, A):
    logits, mask, actions, valid = _inputs(B, T, A, seed=7 + A)
    rng = np.random.RandomState(A)
    w_total = rng.randn(B).astype(np.float32)
    w_step = rng.randn(B, T).astype(np.float32)

    def jax_loss(lg):
        total, per_step = jax_traj_logprob(lg, jnp.asarray(actions),
                                           jnp.asarray(mask),
                                           jnp.asarray(valid))
        return jnp.sum(total * w_total) + jnp.sum(per_step * w_step)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    lg, act, mk, vd = _torch(logits, mask, actions, valid)
    lg.requires_grad_(True)
    total, per_step = ops.traj_logprob(lg, act, mk, vd)
    (total * torch.from_numpy(w_total)).sum().add(
        (per_step * torch.from_numpy(w_step)).sum()).backward()
    np.testing.assert_allclose(lg.grad.numpy(), want, **TOL)
    # the wrapper's backward is the plain closed form on CPU tensors
    np.testing.assert_allclose(
        ops.traj_logprob_backward(lg.detach(), act, mk, vd,
                                  torch.from_numpy(w_total),
                                  torch.from_numpy(w_step)).numpy(),
        want, **TOL)


def test_constant_logits_build_no_graph():
    """The backward direction of the training loss: zero logits that need
    no grad give outputs that need none, so no backward ever runs."""
    logits, mask, actions, valid = _inputs(3, 4, 6, seed=2)
    total, per_step = ops.traj_logprob(
        torch.zeros(3, 4, 6), torch.from_numpy(actions),
        torch.from_numpy(mask), torch.from_numpy(valid))
    assert not total.requires_grad and not per_step.requires_grad
    want = ref_traj_logprob(torch.zeros(3, 4, 6), torch.from_numpy(actions),
                            torch.from_numpy(mask), torch.from_numpy(valid))
    torch.testing.assert_close(per_step, want[1])


def test_plain_backward_is_the_closed_form():
    logits, mask, actions, valid = _inputs(2, 3, 11, seed=5)
    lg, act, mk, vd = _torch(logits, mask, actions, valid)
    g_total, g_step = torch.randn(2), torch.randn(2, 3)
    d = ref_traj_logprob_backward(lg, act, mk, vd, g_total, g_step)
    p = torch.softmax(torch.where(mk, lg, torch.finfo(torch.float32).min),
                      -1)
    onehot = torch.nn.functional.one_hot(act, 11).float()
    want = ((g_total[:, None] + g_step) * vd)[..., None] * (onehot - p)
    torch.testing.assert_close(d, want)
    assert torch.all(d[~vd] == 0)


def test_rejects_bad_operands():
    logits, actions, mask, valid = _torch(*_inputs(2, 3, 5, seed=0))
    with pytest.raises(TypeError, match="mask"):
        ops.traj_logprob(logits, actions, mask.float(), valid)
    with pytest.raises(ValueError, match="do not agree"):
        ops.traj_logprob(logits, actions[:, :2], mask, valid)
