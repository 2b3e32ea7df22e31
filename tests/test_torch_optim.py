"""The port's optimizer transforms (``repro_torch.optim.adamw``) against
the JAX package's ``repro.optim.adamw``: each transform, the chains of
``adam`` / ``adamw`` and of the LM trainer's ``make_optimizer``, and both
schedules, for 3 steps on the same gradients, with float32 and bfloat16
parameters.  Updates, states (named leaf by leaf as JAX's checkpoint
manager names them) and the parameters after ``apply_updates`` are held
to 1e-5 relative plus 1e-6 of each leaf's largest entry (float32: the
same arithmetic, but the clip's global norm sums each leaf in another
order and XLA's and torch's pow and sqrt may differ in the last bit, a
few float32 ulps after 3 steps, which a cancelling sum turns into an
absolute error of the leaf's scale); bf16
parameters after an update to one bf16 ulp, where an fp32 update one ulp
off may round the other way.
Gradients come from numpy with a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402

torch.set_num_threads(2)

SHAPES = {"log_z": (), "model/embed": (6, 4), "model/layers/wq": (2, 4, 3),
          "model/ln_f/scale": (4,)}
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _nest(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _tensors(flat, dtype):
    jdt, tdt = DTYPES[dtype]
    jax_flat = {n: jnp.asarray(a, jnp.float32 if n == "log_z" else jdt)
                for n, a in flat.items()}
    port = {n: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if n == "log_z" else tdt) for n, a in flat.items()}
    return _nest(jax_flat), port


def _draw(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: np.asarray(scale * rng.randn(*s), np.float32)
            for n, s in SHAPES.items()}


def _close32(got, want, name):
    """float32: 1e-5 relative, plus 1e-6 of the leaf's largest entry (an
    entry that a sum cancelled keeps its neighbours' absolute error)."""
    got, want = _np(got), _np(want)
    atol = 1e-6 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                               err_msg=name)


def _check(port, jax_tree):
    want = dict(_flatten(jax_tree)[0])
    assert sorted(port) == sorted(want)
    for n, w in want.items():
        g = port[n]
        assert tuple(g.shape) == tuple(np.shape(w)), n
        _close32(g, w, n)


def _run(jtx, ptx, dtype, steps=3, lr_scale=1.0):
    """3 updates of both transforms on the same gradients; checks updates,
    states and applied parameters after each."""
    jp, pp = _tensors(_draw(0, 0.05), dtype)
    js, ps = jtx.init(jp), ptx.init(pp)
    _check(opt.state_leaves(ps), js)
    for t in range(steps):
        jg, pg = _tensors(_draw(10 + t), dtype)
        ju, js = jtx.update(jg, js, jp)
        pu, ps = ptx.update(pg, ps, pp)
        _check(pu, ju)
        _check(opt.state_leaves(ps), js)
        jp = jopt.apply_updates(jp, ju)
        pp = opt.apply_updates(pp, pu)
        for n, w in dict(_flatten(jp)[0]).items():
            assert pp[n].dtype == {"float32": torch.float32,
                                   "bfloat16": torch.bfloat16}[
                str(np.asarray(jax.device_get(w)).dtype)], n
            if pp[n].dtype == torch.bfloat16:
                np.testing.assert_allclose(_np(pp[n]), _np(w),
                                           rtol=2 ** -7, atol=0, err_msg=n)
            else:
                _close32(pp[n], w, n)
    return ps


TRANSFORMS = {
    "clip": lambda m: m.clip_by_global_norm(1.0),
    "clip_loose": lambda m: m.clip_by_global_norm(100.0),
    "scale_by_adam": lambda m: m.scale_by_adam(0.9, 0.95),
    "decay": lambda m: m.add_decayed_weights(0.1),
    "scale": lambda m: m.scale(-3e-4),
    "label": lambda m: m.scale_by_label(
        lambda n: "log_z" if "log_z" in n else "default",
        {"log_z": 333.0, "default": 1.0}),
    "schedule": lambda m: m.scale_by_schedule(
        m.cosine_schedule(1e-3, 10, warmup=2, final_lr=1e-5)),
    "adam": lambda m: m.adam(3e-4, max_grad_norm=1.0),
    "adamw": lambda m: m.adamw(m.linear_anneal(1e-3, 1e-4, 2),
                               weight_decay=0.01, max_grad_norm=0.5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, dtype):
    _run(TRANSFORMS[name](jopt), TRANSFORMS[name](opt), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_make_optimizer_matches_jax(dtype):
    """The LM trainer's chain (clip, Adam 0.9 / 0.95, decay 0.1, log Z at
    log_z_lr / lr, -lr) with JAX's state names (``1/.count``,
    ``1/.mu/model/embed``); the config's fields, defaults and order."""
    assert steps.LMTrainConfig._fields == jax_steps.LMTrainConfig._fields
    assert tuple(steps.LMTrainConfig()) == tuple(jax_steps.LMTrainConfig())
    tcfg = dict(lr=1e-3, log_z_lr=1e-1)
    ps = _run(jax_steps.make_optimizer(jax_steps.LMTrainConfig(**tcfg)),
              steps.make_optimizer(steps.LMTrainConfig(**tcfg)), dtype)
    assert {"1/.count", "1/.mu/log_z", "1/.nu/model/embed"} <= set(
        opt.state_leaves(ps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", ["adam", "lm"])
def test_adam_moments_update_in_place(chain, dtype):
    """``update`` consumes its state: the returned Adam moments are the
    given tensors, updated in place; the caller's gradients and parameters
    are left as they were (``adam`` without a clip hands Adam the
    caller's gradients themselves)."""
    tx = {"adam": lambda: opt.adam(3e-4),
          "lm": lambda: steps.make_optimizer(steps.LMTrainConfig())}[chain]()
    _, pp = _tensors(_draw(0, 0.05), dtype)
    ps = tx.init(pp)
    for t in range(2):
        _, pg = _tensors(_draw(10 + t), dtype)
        before = {n: g.clone() for n, g in pg.items()}
        p_before = {n: p.clone() for n, p in pp.items()}
        adam = next(s for s in ps if isinstance(s, opt.AdamState))
        mu, nu = dict(adam.mu), dict(adam.nu)
        _, ps = tx.update(pg, ps, pp)
        new = next(s for s in ps if isinstance(s, opt.AdamState))
        assert all(new.mu[n] is mu[n] and new.nu[n] is nu[n] for n in mu)
        assert all(torch.equal(pg[n], before[n]) for n in pg)
        assert all(torch.equal(pp[n], p_before[n]) for n in pp)
        assert int(new.count) == t + 1


def test_int8_compression_waits_for_sharding():
    with pytest.raises(NotImplementedError, match="item 21"):
        steps.make_optimizer(steps.LMTrainConfig(grad_compression="int8_ef"))


@pytest.mark.parametrize("sched", ["cosine", "linear"])
def test_schedules_match_jax(sched):
    make = {"cosine": lambda m: m.cosine_schedule(3e-4, 50, warmup=7,
                                                  final_lr=1e-6),
            "linear": lambda m: m.linear_anneal(2.0, 0.5, 30)}[sched]
    counts = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jax.vmap(make(jopt))(jnp.asarray(counts)))
    got = make(opt)(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    _close32(got, want, sched)


def test_jax_optimizer_state_converts_leaf_for_leaf():
    """``convert.opt_state_from_jax`` of a stepped JAX state keeps every
    leaf (names, dtypes, values) of the chain's tuple."""
    jtx = jax_steps.make_optimizer(jax_steps.LMTrainConfig())
    jp, _ = _tensors(_draw(0, 0.05), "bfloat16")
    js = jtx.init(jp)
    jg, _ = _tensors(_draw(3), "bfloat16")
    _, js = jtx.update(jg, js, jp)
    ps = opt_state_from_jax(jax.device_get(js))
    assert isinstance(ps[1], opt.AdamState)
    leaves = opt.state_leaves(ps)
    want = dict(_flatten(js)[0])
    assert sorted(leaves) == sorted(want)
    for n, w in want.items():
        assert np.array_equal(leaves[n].numpy(), np.asarray(w)), n
    assert leaves["1/.count"].dtype == torch.int32
