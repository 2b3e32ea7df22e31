"""The port's cached AMP rollout with early stops, its correlation
metrics, top-k reward and diversity, and the bitseq exact DP, against the
JAX package's, at the sizes of ``tests/test_torch_seqs.py`` (whose env
pairs and policies they share; the environments, rewards and proxies stay
there).

Tolerances: actions bitwise; logits 1e-5; the DP 1e-6; correlations and
metrics 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.evals.exact import make_bitseq_dp as jax_bitseq_dp  # noqa: E402
from repro.metrics import distributions as jm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.evals import make_bitseq_dp, make_exact_dp  # noqa: E402
from repro_torch.metrics import distributions as tm  # noqa: E402
from test_torch_seqs import (AMP_LEN, CPU, SMALL, _amp_pair,  # noqa: E402
                             _bitseq_policies, _np)

torch.set_num_threads(2)


def test_cached_amp_rollout_with_stops_matches_jax_and_uncached():
    """Rows stop at steps 1, 5 and 10 (the forced stop at max_len): at
    every step the port's cached query (``apply_cached`` at slot
    ``clamp(t, 1, max_len)`` over ``observe_last``) gives the logits of
    its own uncached pass and of JAX's cached policy, and Gumbel-max over
    one shared noise draw picks the same action on all three."""
    jenv, jp, tenv, tp = _amp_pair()
    jpol = make_transformer_policy(jenv.vocab_size, AMP_LEN, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **SMALL)
    jparams = jax.jit(jpol.init)(jax.random.PRNGKey(4))
    tpol = TransformerPolicy(tenv.vocab_size, AMP_LEN, tenv.action_dim,
                             device=CPU, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    stop_at = [1, 5, 10]
    n = len(stop_at)
    rng = np.random.RandomState(3)
    _, js = jenv.reset(n, jp)
    _, ts = tenv.reset(n, tp)
    jcache = jpol.cache_init(jparams, n)
    tcache = tpol.cache_init(n)
    prev = np.zeros(n, np.int64)
    stop = tenv.stop_action
    apply_cached = jax.jit(lambda p, c, tok, pos, ln, t: jpol.apply_cached(
        p, c, tok, pos, ln, step=t))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, jp)[1])
    for t in range(tenv.max_steps):
        jtok, jpos, jlen = jenv.observe_last(js, jp, jnp.asarray(prev))
        ttok, tpos, tlen = tenv.observe_last(ts, tp, torch.from_numpy(prev))
        for a, b in ((jtok, ttok), (jpos, tpos), (jlen, tlen)):
            np.testing.assert_array_equal(_np(a), b.numpy())
        jout, jcache = apply_cached(jparams, jcache, jtok, jpos, jlen,
                                    jnp.int32(t))
        tout, tcache = tpol.apply_cached(tcache, ttok, tpos, tlen, step=t)
        unc = tpol.apply(tenv.observe(ts, tp))
        done = tenv.is_terminal(ts, tp).numpy()
        live = ~done
        want = _np(jout["logits"])[live]
        np.testing.assert_allclose(tout["logits"].numpy()[live], want,
                                   rtol=1e-5, atol=1e-5, err_msg=f"t {t}")
        np.testing.assert_allclose(unc["logits"].numpy()[live], want,
                                   rtol=1e-5, atol=1e-5, err_msg=f"t {t}")
        mask = tenv.forward_mask(ts, tp).numpy()
        gumbel = rng.gumbel(size=mask.shape).astype(np.float32)

        def pick(logits):
            return np.argmax(np.where(mask, logits, -np.inf) + gumbel, -1)

        picks = [pick(_np(jout["logits"])), pick(tout["logits"].numpy()),
                 pick(unc["logits"].numpy())]
        for p in picks[1:]:
            np.testing.assert_array_equal(p[live], picks[0][live])
        # the sampled symbol, or stop at the row's step
        act = np.where(np.asarray(stop_at) == t, stop, picks[0] % stop)
        act = np.where(done, 0, act)
        js = jstep(js, jnp.asarray(act, jnp.int32))
        _, ts, _, _ = tenv.step(ts, torch.from_numpy(act), tp)
        prev = act
    np.testing.assert_array_equal(ts.length.numpy(), stop_at)
    assert ts.stopped.all()
    for f in ("tokens", "length", "steps", "stopped"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      _np(getattr(js, f)))


def test_correlations_with_ties_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randint(0, 6, size=64).astype(np.float32)      # many ties
    y = (x + rng.randint(0, 3, size=64)).astype(np.float32)
    for a, b in ((x, y), (y, x), (x, rng.randn(64).astype(np.float32))):
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        np.testing.assert_array_equal(tm.average_ranks(ta).numpy(),
                                      _np(jm.average_ranks(jnp.asarray(a))))
        np.testing.assert_allclose(
            float(tm.pearson_correlation(ta, tb)),
            float(jm.pearson_correlation(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(tm.spearman_correlation(ta, tb)),
            float(jm.spearman_correlation(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, atol=1e-7)


def test_topk_reward_and_diversity_matches_jax():
    """Rewards floored at r_min, as AMP's are, so the top k cut through a
    run of ties: the stable sort picks JAX's objects."""
    rng = np.random.RandomState(5)
    r = np.maximum(rng.rand(80), 0.6).astype(np.float32)
    objects = rng.randint(0, 4, size=(80, 10)).astype(np.int32)
    for k in (20, 100):
        got = tm.topk_reward_and_diversity(torch.from_numpy(r),
                                           torch.from_numpy(objects), k=k)
        want = jm.topk_reward_and_diversity(jnp.asarray(r),
                                            jnp.asarray(objects), k=k)
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], rtol=1e-6)


@pytest.mark.parametrize("n,k", [(8, 4), (8, 2)])
def test_bitseq_dp_matches_jax(n, k):
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _bitseq_policies(n, k)
    want = _np(jax_bitseq_dp(jenv, jp, jpol.apply)(jparams))
    got = make_bitseq_dp(tenv, tp, tpol)().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got.sum() - 1) < 1e-5
    np.testing.assert_array_equal(make_exact_dp(tenv, tp, tpol)().numpy(),
                                  got)

