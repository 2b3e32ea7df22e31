"""The port's LM training step against the JAX package's, architecture by
architecture (``repro_torch.launch.steps`` against ``repro.launch.steps``).

For each smoke config (2 layers; this file qwen2.5-32b and command-r-35b,
the other eight ``test_torch_lm_train_{dense,fam,rwkv,moe,moe3,enc}.py``,
which import the helpers here), in float32 and in bfloat16: JAX initializes
``init_lm_params`` and the optimizer chain's state, every leaf is perturbed
by 0.02 N(0, 1) from a numpy seed (zero biases and unit norms would hide a
wrong gradient), and ``convert.train_state_from_jax`` carries both across.
On the same ``synthetic_gfn_batch`` (in a float32 model its bf16 embeddings
and frames go in as float32: JAX's layer scan refuses a bf16 carry there)
the two ``loss_fn``'s (TB) total, loss and aux, every gradient leaf, and
then one ``make_train_step`` -- every updated parameter and Adam moment (the
second moment as its square root, the gradient's scale), by JAX's flattened
names -- are held to ``TOL`` (the LM tier's: 1e-4 in float32, the same math
in other orders; 5e-2 in bfloat16, where the frameworks round bf16 matmuls
at other places), each leaf to its largest entry. JAX's side runs jitted."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim.adamw import state_leaves  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 16
CPU = torch.device("cpu")


def configs(arch, dtype):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jax_registry.get_config(arch, smoke=True),
                               dtype=dtype)
    return cfg, jcfg


def jax_state(jcfg, tcfg, seed=0):
    """JAX's params and optimizer state, every leaf perturbed."""
    params = jax_steps.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)

    def perturb(x):
        x = np.asarray(jax.device_get(x))
        return jnp.asarray((x.astype(np.float32) + 0.02 * rng.randn(
            *x.shape)).astype(x.dtype))

    params = jax.tree_util.tree_map(perturb, params)
    return params, jax_steps.make_optimizer(tcfg).init(params)


@functools.lru_cache(maxsize=None)
def jax_step(arch, dtype):
    """Jitted ``(params, opt_state, batch) -> (total, metrics, grads,
    new_params, new_opt_state)``: the body of JAX's ``make_train_step``
    (``value_and_grad`` of ``loss_fn``, ``tx.update``, ``apply_updates``),
    its gradients returned too (one backward to compile)."""
    _, jcfg = configs(arch, dtype)
    tcfg = jax_steps.LMTrainConfig()
    tx = jax_steps.make_optimizer(tcfg)

    def f(params, opt_state, batch):
        (total, metrics), grads = jax.value_and_grad(
            functools.partial(jax_steps.loss_fn, cfg=jcfg, tcfg=tcfg,
                              batch=batch), has_aux=True)(params)
        updates, new_state = tx.update(grads, opt_state, params)
        return (total, metrics, grads, jopt.apply_updates(params, updates),
                new_state)

    return jax.jit(f)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jax.device_get(x)).astype(np.float32)


def torch_dtype(x):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[np.asarray(jax.device_get(x)).dtype.name]


def close(got, want, tol, name):
    """max |got - want| <= tol * max |want| (both exactly zero passes)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (name, err, scale)


def check_arch(arch, dtype):
    cfg, jcfg = configs(arch, dtype)
    tcfg = steps.LMTrainConfig()
    assert tuple(tcfg) == tuple(jax_steps.LMTrainConfig())
    jp, js = jax_state(jcfg, jax_steps.LMTrainConfig())
    jbatch = jax_tokens.synthetic_gfn_batch(jcfg, B, S, seed=1, step=0)
    if dtype == "float32":
        # the batch's bf16 embeddings / frames in a float32 model: JAX's
        # layer scan refuses the bf16 carry, so both sides take them in
        # float32
        jbatch = {k: (v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v) for k, v in jbatch.items()}
    total, metrics, grads, new_p, new_s = jax_step(arch, dtype)(jp, js,
                                                                 jbatch)
    params, opt_state = train_state_from_jax(jax.device_get(jp),
                                             jax.device_get(js), CPU)
    batch = tokens.synthetic_gfn_batch(cfg, B, S, seed=1, step=0,
                                       device=CPU)
    if dtype == "float32":
        batch = {k: (v.float() if v.dtype == torch.bfloat16 else v)
                 for k, v in batch.items()}
    tol = TOL[dtype]

    # the loss and every gradient leaf
    leaves = steps.param_leaves(params)
    t_total, t_metrics = steps.loss_fn(params, cfg, tcfg, batch)
    t_grads = torch.autograd.grad(t_total, list(leaves.values()),
                                  materialize_grads=True)
    close(t_total, total, tol, "total")
    close(t_metrics["loss"], metrics["loss"], tol, "loss")
    close(t_metrics["aux"], metrics["aux"], tol, "aux")
    want = dict(_flatten(grads)[0])
    assert sorted(want) == sorted(leaves)
    for name, g in zip(leaves, t_grads):
        assert g.dtype == leaves[name].dtype, name
        close(g, want[name], tol, f"grad {name}")

    # one train step: the updated parameters and optimizer state
    params, opt_state, t_m = steps.make_train_step(cfg, tcfg)[0](
        params, opt_state, batch)
    close(t_m["loss"], metrics["loss"], tol, "step loss")
    want = dict(_flatten((new_p, new_s))[0])
    got = {**state_leaves(params, "0"), **state_leaves(opt_state, "1")}
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch_dtype(want[name]), name
        w = want[name]
        if "/.nu/" in name:      # a squared gradient: held as its root
            t, w = t.sqrt(), np.sqrt(np32(w))
        close(t, w, tol, f"step {name}")
    assert int(got["1/1/.count"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "command-r-35b"])
def test_dense_loss_gradients_and_train_step_match_jax(arch, dtype):
    check_arch(arch, dtype)
