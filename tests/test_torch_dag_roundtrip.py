"""The DAG environment's forward / backward round trip at the seeds where
the JAX package's property test ``tests/test_envs.py::
TestForwardBackwardRoundTrip::test_roundtrip[dag]`` fails (ROADMAP queue
3, reference item 10): 13 of its seeds 0-303 (~4.3 %), so ~12 % of its
runs at ``max_examples=3``.

The test's body, replayed on both packages in lockstep (d = 3, 4 rows,
its ``RandomState(seed)`` choosing legal actions): a forward step and
the backward step of its structural reverse.  The carried ``log_r`` adds
the delta score on the way forward and subtracts it on the way back, in
float32, so it can come back one ulp off (-97.450584 against -97.45058);
the JAX test compares that leaf bitwise.  Held here, at every step:

- the port's discrete leaves (adjacency, closure, parent masks, edge
  count, stop flag, steps) come back bitwise;
- the port's ``log_r`` comes back within the float32 bound of one add and
  one subtract, ``2**-24 * (|log_r + delta| + |log_r|)``;
- the port's ``log_r`` after each forward and each backward step has the
  JAX package's bits;
- at each of these seeds some row does come back off by rounding (the
  reference's failure, reproduced on both packages).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro_torch.recipes import dag as dag_recipe  # noqa: E402

torch.set_num_threads(2)

#: seeds of 0-303 where the JAX test fails (found by calling its body)
FAILING_SEEDS = (50, 57, 122, 135, 136, 153, 157, 170, 217, 272, 285, 289,
                 303)
DISCRETE = ("adj", "reach", "pa_mask", "num_edges", "stopped", "steps")
B = 4


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def pair():
    jenv = repro.DAGEnvironment(d=3)
    jp = jenv.init(jax.random.PRNGKey(0))
    tenv = dag_recipe.dag_env(d=3)
    step = jax.jit(lambda s, a: jenv.step(s, a, jp)[1])
    back = jax.jit(lambda s, a: jenv.backward_step(s, a, jp)[1])
    rev = jax.jit(lambda s, a, n: jenv.get_backward_action(s, a, n, jp))
    return jenv, jp, step, back, rev, tenv, tenv.init(torch.device("cpu"))


@pytest.mark.parametrize("seed", FAILING_SEEDS)
def test_dag_roundtrip_log_r_within_one_add_and_subtract(pair, seed):
    jenv, jp, jstep, jback, jrev, tenv, tp = pair
    rng = np.random.RandomState(seed)
    _, js = jenv.reset(B, jp)
    _, ts = tenv.reset(B, tp)
    off_by_rounding = 0
    for t in range(jenv.max_steps):
        was_done = _np(jenv.is_terminal(js, jp))
        if was_done.all():
            break
        fmask = _np(jenv.forward_mask(js, jp))
        np.testing.assert_array_equal(tenv.forward_mask(ts, tp).numpy(),
                                      fmask)
        safe = np.where(was_done[:, None], np.ones_like(fmask), fmask)
        probs = safe / safe.sum(-1, keepdims=True)
        actions = np.asarray([rng.choice(jenv.action_dim, p=p)
                              for p in probs], np.int32)
        jn = jstep(js, jnp.asarray(actions))
        _, tn, _, _ = tenv.step(ts, torch.from_numpy(actions).long(), tp)
        live = ~was_done
        jbwd = jrev(js, jnp.asarray(actions), jn)
        tbwd = tenv.get_backward_action(ts, torch.from_numpy(actions).long(),
                                        tn, tp)
        np.testing.assert_array_equal(tbwd.numpy(), _np(jbwd))
        jb = jback(jn, jbwd)
        _, tb, _, _ = tenv.backward_step(tn, tbwd, tp)
        for name in DISCRETE:
            np.testing.assert_array_equal(
                getattr(tb, name).numpy()[live],
                getattr(ts, name).numpy()[live], err_msg=f"{name} t {t}")
        # the port's carried log R has JAX's bits, forward and back
        for tx, jx, what in ((tn, jn, "forward"), (tb, jb, "backward")):
            np.testing.assert_array_equal(tx.log_r.numpy(), _np(jx.log_r),
                                          err_msg=f"{what} log_r t {t}")
        a = ts.log_r.numpy().astype(np.float64)
        ad = tn.log_r.numpy().astype(np.float64)
        bound = 2.0 ** -24 * (np.abs(ad) + np.abs(a))
        err = np.abs(tb.log_r.numpy().astype(np.float64) - a)
        assert (err[live] <= bound[live]).all(), (t, err, bound)
        off_by_rounding += int((err[live] > 0).sum())
        js, ts = jn, tn
    # the JAX test's failure at this seed: a log_r one rounding off
    assert off_by_rounding > 0
