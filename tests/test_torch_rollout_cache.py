"""The port's pop-only cached backward rollout, held to the JAX package's
``tests/test_rollout_cache.py::TestBackwardCached`` cases on the port and
to the JAX package itself: on tfbind8 (uniform P_B) and AMP at max_len 10
(a transformer with a learned backward head), the cached rollout against
the uncached one and both against JAX's, for the sampled actions, log P_F
and log P_B; bitseq, whose backward edits any position, stays uncached;
``use_cache=True`` raises where JAX's raises; the cache's two entry points
(``cache_fill``, ``query_cached``) against a full pass; the rollout
evaluates only the heads it reads; and the evals' backward rollouts stay
uncached, as JAX's, which pass the bare ``policy.apply``.

Noise: the backward rollout's Gumbels replay JAX's (``key_c`` of the fold
of ``split(key, T)[t]`` with row r); the terminals come from JAX's forward
rollout.

Tolerances (fp32 on both sides): actions bitwise; log P_F and log P_B
1e-4 absolute, the JAX test's own bound for cached against uncached; the
cache's heads 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.rollout import backward_rollout as jax_backward  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward  # noqa: E402
from repro.envs import sequences as jseq  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import rollout as trollout  # noqa: E402
from repro_torch.core.policies import MLPPolicy, TransformerPolicy  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.rewards.amp import AMPRewardModule  # noqa: E402
from test_torch_samplers import replay_backward_gumbel  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(7)
SMALL = dict(num_layers=2, dim=32, num_heads=4)
ATOL = 1e-4


def _np(x):
    return np.array(x)


def _case(name):
    """(jax env, params, policy, policy params, port env, params, policy)
    of the JAX test's ``_env_cases``."""
    if name == "tfbind8":
        jenv = jseq.TFBind8Environment()
        tenv = tseq.TFBind8Environment()
        max_len, lb = 8, False
    else:
        jenv = jseq.AMPEnvironment(max_len=10)
        jp = jenv.init(KEY)
        proxy = {k: v for k, v in jax.device_get(jp).items() if k != "r_min"}
        tenv = tseq.AMPEnvironment(AMPRewardModule(max_len=10, proxy=proxy),
                                   max_len=10)
        max_len, lb = 10, True
    jpol = make_transformer_policy(jenv.vocab_size, max_len, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   learn_backward=lb, **SMALL)
    jparams = jpol.init(KEY)
    tpol = TransformerPolicy(tenv.vocab_size, max_len=max_len,
                             action_dim=tenv.action_dim, arch="decode",
                             backward_action_dim=tenv.backward_action_dim,
                             learn_backward=lb, device=CPU, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return jenv, jenv.init(KEY), jpol, jparams, tenv, tenv.init(CPU), tpol


def _terminals(name, jenv, jp, jpol, jparams, tenv):
    batch = jax_forward(KEY, jenv, jp, jpol, jparams, 6)
    term = batch.obs[-1]
    if name == "amp":
        lengths = jnp.sum(term != jenv.pad, axis=-1)
        return (jenv.terminal_state_from_tokens(term, lengths),
                tenv.terminal_state_from_tokens(
                    torch.from_numpy(_np(term)),
                    torch.from_numpy(_np(lengths))))
    return (jenv.terminal_state_from_tokens(term),
            tenv.terminal_state_from_tokens(torch.from_numpy(_np(term))))


@pytest.fixture(scope="module", params=["tfbind8", "amp"])
def pop_only(request):
    name = request.param
    jenv, jp, jpol, jparams, tenv, tp, tpol = _case(name)
    jts, tts = _terminals(name, jenv, jp, jpol, jparams, tenv)
    jr = jax_backward(KEY, jenv, jp, jpol, jparams, jts, collect=True)
    noise = replay_backward_gumbel(lambda i: KEY, tenv.max_steps)
    tr = {c: trollout.backward_rollout(0, tenv, tp, tpol, tts, noise=noise,
                                       collect=True, use_cache=c)
          for c in ("auto", True, False)}
    return name, jr, tr, (tenv, tp, tpol, tts)


def test_pop_only_backward_parity(pop_only):
    """Cached (auto and True) against uncached against JAX's (whose
    default, "auto", is its cached path here)."""
    name, jr, tr, _ = pop_only
    for c, r in tr.items():
        np.testing.assert_array_equal(r.batch.actions.numpy(),
                                      _np(jr.batch.actions),
                                      err_msg=f"{name} use_cache={c}")
        np.testing.assert_array_equal(r.batch.bwd_actions.numpy(),
                                      _np(jr.batch.bwd_actions))
        np.testing.assert_allclose(r.log_pf.numpy(), _np(jr.log_pf),
                                   atol=ATOL, err_msg=f"{name} {c}")
        np.testing.assert_allclose(r.log_pb.numpy(), _np(jr.log_pb),
                                   atol=ATOL, err_msg=f"{name} {c}")
    un, ca = tr[False], tr[True]
    np.testing.assert_allclose(un.log_pf.numpy(), ca.log_pf.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(un.log_pb.numpy(), ca.log_pb.numpy(),
                               atol=ATOL)
    assert torch.equal(tr["auto"].log_pf, ca.log_pf)
    # the trajectories are real: most rows took several backward steps
    assert int(un.batch.valid.sum()) > 6


def _spy(policy, names):
    calls = []
    for fn in names:
        real = getattr(policy, fn)

        def spy(*a, _fn=fn, _real=real, **k):
            calls.append(_fn)
            return _real(*a, **k)
        setattr(policy, fn, spy)
    return calls


def _unspy(policy, names):
    for fn in names:
        delattr(policy, fn)


ENTRY = ("apply", "cache_init", "cache_fill", "query_cached")


def test_cached_backward_queries_the_cache_only(pop_only):
    """The cached rollout fills the cache once and queries it once per step
    for log P_F, and once more per step for a learned P_B; no full pass."""
    name, _, _, (tenv, tp, tpol, tts) = pop_only
    calls = _spy(tpol, ENTRY)
    try:
        trollout.backward_rollout(0, tenv, tp, tpol, tts)
        cached = list(calls)
        calls.clear()
        trollout.backward_rollout(0, tenv, tp, tpol, tts, use_cache=False)
        uncached = list(calls)
    finally:
        _unspy(tpol, ENTRY)
    T = tenv.max_steps
    per_step = 2 if name == "amp" else 1
    assert cached == ["cache_init", "cache_fill"] + \
        ["query_cached"] * (per_step * T)
    assert uncached == ["apply"] * (per_step * T)


@pytest.mark.parametrize("case", ["tfbind8", "amp"])
def test_cache_entry_points_match_a_full_pass(case):
    """``query_cached`` at a prefix length of a cache that ``cache_fill``
    filled from the whole sequence gives the heads of a full pass over that
    prefix (pads past it), and JAX's ``query_cached``."""
    jenv, jp, jpol, jparams, tenv, tp, tpol = _case(case)
    rng = np.random.default_rng(3)
    L = tpol.max_len
    tokens = rng.integers(0, tenv.vocab, size=(5, L)).astype(np.int32)
    lengths = np.array([0, 1, L // 2, L - 1, L], np.int32)
    cache = tpol.cache_fill(tpol.cache_init(5), torch.from_numpy(tokens))
    got = tpol.query_cached(cache, torch.from_numpy(lengths))
    prefix = np.where(np.arange(L)[None] < lengths[:, None], tokens,
                      tenv.pad).astype(np.int32)
    full = tpol.apply(torch.from_numpy(prefix))
    jcache = jpol.cache_fill(jparams, jpol.cache_init(jparams, 5),
                             jnp.asarray(tokens))
    want = jpol.query_cached(jparams, jcache, jnp.asarray(lengths))
    assert set(got) == set(full) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   full[k].detach().numpy(), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   atol=1e-5, err_msg=k)


def test_bitseq_backward_stays_uncached():
    """Arbitrary-position removal cannot reuse the cache: "auto" re-encodes
    (and still works), True raises, as in JAX."""
    jenv = JaxBitSeq(n=16, k=4)
    tenv = BitSeqEnvironment(n=16, k=4)
    tpol = TransformerPolicy(tenv.vocab_size, max_len=tenv.L,
                             action_dim=tenv.action_dim, arch="decode",
                             device=CPU, **SMALL)
    tp = tenv.init(CPU)
    ts = tenv.terminal_state_from_words(torch.zeros(4, tenv.L,
                                                    dtype=torch.int32))
    calls = _spy(tpol, ENTRY)
    try:
        out = trollout.backward_rollout(0, tenv, tp, tpol, ts)
    finally:
        _unspy(tpol, ENTRY)
    assert set(calls) == {"apply"}
    assert torch.isfinite(out.log_pf).all()
    assert not jenv.incremental_pop_only and not tenv.incremental_pop_only
    with pytest.raises(ValueError, match="pop-only edit regime"):
        trollout.backward_rollout(0, tenv, tp, tpol, ts, use_cache=True)


def test_use_cache_true_raises_where_jax_raises():
    jenv, jp, jpol, jparams, tenv, tp, tpol = _case("tfbind8")
    jts, tts = _terminals("tfbind8", jenv, jp, jpol, jparams, tenv)
    # a policy without cache entry points (the pooled arch, the MLP)
    pooled = TransformerPolicy(tenv.vocab_size, max_len=8,
                               action_dim=tenv.action_dim, arch="pooled",
                               device=CPU, **SMALL)
    with pytest.raises(ValueError, match="cache entry points"):
        trollout.backward_rollout(0, tenv, tp, pooled, tts, use_cache=True)
    with pytest.raises(ValueError, match="cache entry points"):
        jax_backward(KEY, jenv, jp, jpol.apply, jparams, jts, use_cache=True)
    # no per-step evaluation: a uniform P_B without log P_F
    kw = dict(backward_policy="uniform", with_log_pf=False, use_cache=True)
    with pytest.raises(ValueError, match="pop-only edit regime"):
        jax_backward(KEY, jenv, jp, jpol, jparams, jts, **kw)
    with pytest.raises(ValueError, match="pop-only edit regime"):
        trollout.backward_rollout(0, tenv, tp, tpol, tts, **kw)
    # JAX's learned P_B on a policy without logits_b engages (it needs a
    # per-step evaluation by its reckoning) and raises nothing; the port
    # neither raises nor evaluates
    jax_backward(KEY, jenv, jp, jpol, jparams, jts, with_log_pf=False,
                 use_cache=True)
    calls = _spy(tpol, ENTRY)
    try:
        trollout.backward_rollout(0, tenv, tp, tpol, tts, with_log_pf=False,
                                  use_cache=True)
    finally:
        _unspy(tpol, ENTRY)
    assert calls == []
    with pytest.raises(ValueError, match="use_cache"):
        trollout.backward_rollout(0, tenv, tp, tpol, tts, use_cache="yes")


def test_a_learned_backward_without_a_head_evaluates_nothing():
    """backward_policy="learned" on a policy with no ``logits_b`` head
    (JAX's jit drops the unused pass): with ``with_log_pf`` only the log
    P_F pass runs; without it, no pass.  An MLP with the head evaluates it
    at every step."""
    from repro_torch.envs.hypergrid import HypergridEnvironment
    from repro_torch.rewards.hypergrid import HypergridRewardModule
    env = HypergridEnvironment(HypergridRewardModule(), dim=2, side=4)
    params = env.init(CPU)
    term = env.terminal_state_from_flat_index(torch.arange(5))
    for lb, with_pf, want in ((False, False, 0), (False, True, 1),
                              (True, False, 1), (True, True, 2)):
        pol = MLPPolicy(env.obs_dim, env.action_dim,
                        env.backward_action_dim, hidden=(8,),
                        learn_backward=lb, device=CPU)
        calls = _spy(pol, ("apply",))
        try:
            trollout.backward_rollout(0, env, params, pol, term,
                                      with_log_pf=with_pf)
        finally:
            _unspy(pol, ("apply",))
        assert len(calls) == want * env.max_steps, (lb, with_pf)


def test_eval_backward_rollouts_stay_uncached():
    """The EUBO's backward rollout (``evals.LogZBoundsEval``) and the
    marginal estimate (``metrics.distributions``) pass ``use_cache=False``:
    JAX's evals pass the bare ``policy.apply``, so they never engage the
    cache."""
    from repro_torch.evals.bounds import LogZBoundsEval
    from repro_torch.metrics.distributions import log_prob_mc_estimate
    _, _, _, _, tenv, tp, tpol = _case("tfbind8")
    ts = tenv.terminal_state_from_tokens(torch.zeros(3, 8,
                                                     dtype=torch.int32))
    calls = _spy(tpol, ENTRY + ("apply_cached",))
    try:
        LogZBoundsEval(tenv, tp, tpol, num_samples=3, target_states=ts,
                       target_log_r=tenv.log_reward(ts, tp))(0)
        log_prob_mc_estimate(0, tenv, tp, tpol, ts, num_samples=2)
    finally:
        _unspy(tpol, ENTRY + ("apply_cached",))
    assert "cache_fill" not in calls and "query_cached" not in calls
    assert "apply" in calls
