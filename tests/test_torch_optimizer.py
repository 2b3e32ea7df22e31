"""The port's ``make_optimizer`` against the JAX package's on the same
gradients: three steps with ``max_grad_norm`` (binding and not) and
``weight_decay``, with log Z at its own learning rate.

Tolerance (fp32 on both sides; Adam's bias corrections, the global norm
and AdamW's decay round in another order): parameters within 1e-4 of the
group's learning rate per step absolute and 1e-6 relative, Adam's moments
within 1e-5 relative and 1e-9 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.optim import adamw as jax_optim  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.trainer import GFNConfig, make_optimizer  # noqa: E402
from repro_torch.nn.core import ParamTree  # noqa: E402

torch.set_num_threads(2)

LR, LOG_Z_LR, STEPS = 1e-2, 1e-1, 3
MOMENTS = dict(rtol=1e-5, atol=1e-9)
SHAPES = {"log_z": (), "torso": {"layer_0": {"w": (6, 8), "b": (8,)},
                                 "layer_1": {"w": (8, 3), "b": (3,)}}}


def _draw(rng, shapes, scale):
    return {k: _draw(rng, v, scale) if isinstance(v, dict)
            else np.asarray(scale * rng.randn(*v), np.float32)
            for k, v in shapes.items()}


@pytest.mark.parametrize("max_norm,wd", [(0.5, 1e-2), (1e3, 1e-2),
                                         (0.5, 0.0), (None, 1e-2)])
def test_three_steps_match_jax(max_norm, wd):
    rng = np.random.RandomState(0)
    params = _draw(rng, SHAPES, 0.5)
    grads = [_draw(rng, SHAPES, 2.0) for _ in range(STEPS)]
    kw = dict(lr=LR, log_z_lr=LOG_Z_LR, max_grad_norm=max_norm,
              weight_decay=wd)
    tx = jax_make_optimizer(JaxGFNConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tree = ParamTree(params, requires_grad=True)
    opt = make_optimizer(GFNConfig(**kw), tree)
    named = tree.flat()
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax_optim.apply_updates(jp, upd)
        for n, t in params_from_jax(g).items():
            named[n].grad = t.clone()
        opt.step()
    want = params_from_jax(jax.device_get(jp))
    for n, p in named.items():
        lr = LOG_Z_LR if n == "log_z" else LR
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   err_msg=n, rtol=1e-6,
                                   atol=1e-4 * lr * STEPS)
    adam = js[0 if max_norm is None else 1]
    assert int(adam.count) == STEPS
    mu = params_from_jax(jax.device_get(adam.mu))
    nu = params_from_jax(jax.device_get(adam.nu))
    for n, p in named.items():
        st = opt.state[p]
        assert float(st["step"]) == STEPS
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n].numpy(),
                                   err_msg=n, **MOMENTS)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n].numpy(),
                                   err_msg=n, **MOMENTS)


def test_clip_scales_to_the_global_norm():
    from repro_torch.core.trainer import clip_by_global_norm_
    tree = ParamTree({"a": np.zeros(3, np.float32),
                      "b": np.zeros(4, np.float32)}, requires_grad=True)
    tree["a"].grad = torch.tensor([3.0, 0.0, 0.0])
    tree["b"].grad = torch.tensor([0.0, 4.0, 0.0, 0.0])
    clip_by_global_norm_(list(tree.parameters()), 1.0)
    gn = torch.cat([tree["a"].grad, tree["b"].grad]).norm()
    np.testing.assert_allclose(float(gn), 5.0 / (5.0 + 1e-9), rtol=1e-6)
    # under the bound: untouched
    clip_by_global_norm_(list(tree.parameters()), 10.0)
    np.testing.assert_allclose(float(torch.cat(
        [tree["a"].grad, tree["b"].grad]).norm()), float(gn), rtol=1e-7)
