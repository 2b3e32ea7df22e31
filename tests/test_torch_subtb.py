"""The port's SubTB loss against the JAX package's.

Forward: ``ops.subtb_loss`` on CPU tensors (its plain version,
``ref_subtb``) against ``repro.kernels.ref.ref_subtb``, the Pallas kernel
``subtb_loss_pallas`` in interpret mode (as ``tests/test_kernels.py`` runs
it), and JAX's dense and prefix forms, over the shape sweep of
``tests/test_kernels.py`` plus lengths 0, 1 and T and
lambda in {0.5, 0.9, 0.99, 1.0}: rtol 1e-4, the tolerance of JAX's own
tests (the Pallas kernel weighs pairs by exp((k-j) log lambda), the dense
form by lambda**(k-j)).  Backward: ``ref_subtb_backward`` (the closed
form) against torch autograd of ``ref_subtb`` and ``jax.vjp`` of
``repro.core.objectives._subtb_pallas`` (which differentiates the prefix
recurrence), each to 1e-4 of the tensor's largest entry.  The CUDA kernels
are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.objectives import _subtb_dense as jax_dense  # noqa: E402
from repro.core.objectives import _subtb_pallas as jax_pallas_vjp  # noqa: E402
from repro.core.objectives import _subtb_prefix as jax_prefix  # noqa: E402
from repro.kernels.ref import ref_subtb as jax_ref  # noqa: E402
from repro.kernels.subtb_loss import subtb_loss_pallas  # noqa: E402
from repro_torch.core.objectives import _subtb_prefix  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_subtb, ref_subtb_backward  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-4
#: (B, T+1, lambda, Pallas block): tests/test_kernels.py's sweep
SWEEP = [(4, 16, 0.9, 8), (3, 100, 0.8, 32), (2, 64, 0.99, 64),
         (1, 7, 0.5, 8)]
LAMS = [0.5, 0.9, 0.99, 1.0]


def _inputs(B, T1, seed):
    """phi (B, T+1) and lengths in [0, T] with 0, 1 and T among them."""
    rng = np.random.RandomState(seed)
    phi = rng.randn(B, T1).astype(np.float32)
    length = rng.randint(0, T1, size=B).astype(np.int32)
    length[:3] = [0, 1, T1 - 1][:B]
    return phi, length


def _jax_forms(phi, length, lam, block):
    jphi, jlen = jnp.asarray(phi), jnp.asarray(length)
    return {"ref": jax_ref(jphi, jlen, lam),
            "pallas": subtb_loss_pallas(jphi, jlen, lam=lam, block=block,
                                        interpret=True),
            "dense": jax_dense(jphi.T, jlen, lam),
            "prefix": jax_prefix(jphi.T, jlen, lam)}


@pytest.mark.parametrize("B,T1,lam,block", SWEEP)
def test_forward_matches_jax_sweep(B, T1, lam, block):
    phi, length = _inputs(B, T1, seed=T1)
    got = ops.subtb_loss(torch.from_numpy(phi), torch.from_numpy(length),
                         lam).numpy()
    assert got.shape == (B,)
    assert got[0] == 0.0                     # n = 0: exactly 0
    for name, want in _jax_forms(phi, length, lam, block).items():
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("B,T1,block", [(5, 30, 32), (3, 78, 128)])
def test_forward_matches_jax_lambdas(B, T1, block, lam):
    """The recipe's T+1 = 30 (4x8^4) and the paper grid's 78 (20^4)."""
    phi, length = _inputs(B, T1, seed=int(lam * 100) + T1)
    t_phi, t_len = torch.from_numpy(phi), torch.from_numpy(length)
    got = ops.subtb_loss(t_phi, t_len, lam).numpy()
    for name, want in _jax_forms(phi, length, lam, block).items():
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=0, err_msg=name)
    # the port's own prefix form (the CPU's beyond 64 states) agrees
    np.testing.assert_allclose(
        _subtb_prefix(t_phi.T, t_len.long(), lam).numpy(), got,
        rtol=RTOL, atol=1e-6)


def _max_err_over_scale(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("B,T1", [(4, 16), (5, 30), (3, 78)])
def test_backward_matches_autograd_and_jax(B, T1, lam):
    phi, length = _inputs(B, T1, seed=T1 + 7)
    g = np.random.RandomState(T1).randn(B).astype(np.float32)
    t_phi = torch.from_numpy(phi)
    t_len, t_g = torch.from_numpy(length), torch.from_numpy(g)
    closed = ref_subtb_backward(t_phi, t_len, lam, t_g).numpy()
    # past n the gradient is exactly 0
    past = np.arange(T1)[None, :] > length[:, None]
    assert (closed[past] == 0).all()
    x = t_phi.clone().requires_grad_(True)
    (ref_subtb(x, t_len, lam) * t_g).sum().backward()
    assert _max_err_over_scale(closed, x.grad.numpy()) <= 1e-4
    _, vjp = jax.vjp(lambda p: jax_pallas_vjp(p, jnp.asarray(length), lam),
                     jnp.asarray(phi).T)
    want = np.asarray(vjp(jnp.asarray(g))[0]).T
    assert _max_err_over_scale(closed, want) <= 1e-4


def test_autograd_function_runs_the_closed_form_on_cpu():
    """Gradients through ``ops.subtb_loss`` of a transposed time-major view
    (the loss's layout) come from ``subtb_loss_backward``."""
    phi, length = _inputs(4, 30, seed=1)
    tm = torch.from_numpy(phi.T.copy()).requires_grad_(True)     # (T+1, B)
    g = torch.linspace(-1, 1, 4)
    (ops.subtb_loss(tm.T, torch.from_numpy(length).long(), 0.9) * g
     ).sum().backward()
    want = ref_subtb_backward(torch.from_numpy(phi),
                              torch.from_numpy(length), 0.9, g)
    torch.testing.assert_close(tm.grad.T, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(length=torch.tensor([0, 30])), "lengths must lie"),
    (dict(length=torch.tensor([-1, 3])), "lengths must lie"),
    (dict(lam=0.0), "lam must lie"),
    (dict(lam=1.5), "lam must lie"),
    (dict(phi=torch.zeros(2, 30, dtype=torch.float64)), "dtype"),
    (dict(length=torch.tensor([1.0, 2.0])), "int32 or int64"),
    (dict(length=torch.tensor([1, 2, 3])), "do not agree"),
])
def test_wrapper_refuses_bad_operands(bad, match):
    args = dict(phi=torch.zeros(2, 30), length=torch.tensor([0, 29]),
                lam=0.9)
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.subtb_loss(args["phi"], args["length"], args["lam"])
