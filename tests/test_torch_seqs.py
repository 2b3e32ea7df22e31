"""The port's sequence environments, rewards and metrics against the JAX
package's: bitseq's backward steps and flip test set, TFBind8, QM9 and AMP
step by step on the same actions, their rewards and enumerable targets,
the proxies carried across from JAX, the cached AMP rollout with early
stops, the correlation metrics, top-k reward and diversity, and the bitseq
exact DP.  The evaluators are held in ``tests/test_torch_seqs_evals.py``.

    python tests/test_torch_seqs.py --write-proxies

writes ``src/repro_torch/rewards/proxies.npz``: the QM9 and AMP proxies
that JAX draws at seed 0, under ``params_from_jax``'s names (the port
cannot redraw them; it imports no JAX).

Tolerances: steps, masks and actions bitwise; rewards 1e-6 relative, with
an absolute floor of 1e-6 of the largest |log R| over a whole target (the
proxies are fp32 matmuls in another order, and beta = 10 multiplies a
last-bit difference in a score near 1 into log R near 0); the DP 1e-6;
correlations and metrics 1e-5.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.envs import sequences as jseq  # noqa: E402
from repro.envs.base import EnvSpec  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro.evals.exact import make_bitseq_dp as jax_bitseq_dp  # noqa: E402
from repro.metrics import distributions as jm  # noqa: E402
from repro.rewards.amp import AMPRewardModule as JaxAMPReward  # noqa: E402
from repro.rewards.bitseq import make_test_set as jax_make_test_set  # noqa: E402
from repro.rewards.qm9 import QM9RewardModule as JaxQM9Reward  # noqa: E402
from repro.rewards.tfbind8 import synth_binding_table as jax_table  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.evals import make_bitseq_dp, make_exact_dp  # noqa: E402
from repro_torch.metrics import distributions as tm  # noqa: E402
from repro_torch.rewards import proxies  # noqa: E402
from repro_torch.rewards.amp import AMPRewardModule  # noqa: E402
from repro_torch.rewards.bitseq import make_test_set  # noqa: E402
from repro_torch.rewards.tfbind8 import synth_binding_table  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROXIES = ROOT / "src" / "repro_torch" / "rewards" / "proxies.npz"
CPU = torch.device("cpu")
SMALL = dict(num_layers=2, dim=32, num_heads=4)
AMP_LEN = 10
REL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(x)


def jax_proxies():
    """The QM9 MLP and the AMP classifier that the JAX package draws at
    seed 0 (at the recipes' sizes: 5 blocks of 11, AMP max_len 60), as
    ``/``-keyed numpy leaves prefixed ``qm9/`` and ``amp/``; and the AMP
    positional table JAX draws at each shorter length of
    ``proxies.AMP_LENGTHS``, prefixed ``amp_len<n>/``."""
    qm9 = JaxQM9Reward().init(jax.random.PRNGKey(1),
                              EnvSpec(kind="sequence", length=5, vocab=11))
    trees = [("qm9", qm9["proxy"])]
    for n in proxies.AMP_LENGTHS:
        amp = JaxAMPReward(max_len=n).init(
            jax.random.PRNGKey(1), EnvSpec(kind="sequence", length=n,
                                           vocab=20))
        trees.append(("amp", {k: v for k, v in amp.items() if k != "r_min"})
                     if n == proxies.AMP_LENGTHS[0]
                     else (f"amp_len{n}", {"pos": amp["pos"]}))
    flat = {}
    for name, tree in trees:
        for k, v in params_from_jax(jax.device_get(tree)).items():
            flat[f"{name}/{k}"] = v.numpy()
    return flat


def write_proxies(path=PROXIES):
    np.savez(path, **jax_proxies())


# -- the proxies carried across ----------------------------------------------

def test_proxies_file_equals_jax_draws_bitwise():
    want = jax_proxies()
    with np.load(PROXIES) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype == np.float32, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_proxies_exist_for_seed_0_only():
    with pytest.raises(ValueError, match="write-proxies"):
        proxies.load_proxy("qm9", 1, CPU)
    with pytest.raises(ValueError, match="write-proxies"):
        tseq.AMPEnvironment().reward_module.__class__(seed=2).init(CPU)


# -- tables drawn with numpy --------------------------------------------------

def test_binding_table_and_test_set_are_jax_bit_for_bit():
    np.testing.assert_array_equal(synth_binding_table(0), jax_table(0))
    np.testing.assert_array_equal(synth_binding_table(3), jax_table(3))
    modes = JaxBitSeq(n=16, k=4).init(jax.random.PRNGKey(0)).modes
    np.testing.assert_array_equal(make_test_set(5, _np(modes)),
                                  jax_make_test_set(5, _np(modes)))


# -- rewards and targets ---------------------------------------------------------

def test_enumerable_targets_match_jax():
    for jenv, tenv in ((jseq.TFBind8Environment(), tseq.TFBind8Environment()),
                       (jseq.QM9Environment(), tseq.QM9Environment())):
        want = _np(jenv.true_log_rewards(jenv.init(jax.random.PRNGKey(0))))
        got = tenv.true_log_rewards(tenv.init(CPU)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        assert tenv.num_terminal_states == jenv.num_terminal_states


def test_amp_reward_matches_jax_at_full_length():
    """The asset's classifier against JAX's own seed-0 draw, max_len 60,
    on ragged terminal sequences."""
    jenv, tenv = jseq.AMPEnvironment(), tseq.AMPEnvironment()
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, 61, size=24).astype(np.int32)
    tokens = rng.randint(0, 20, size=(24, 60)).astype(np.int32)
    tokens[np.arange(60)[None] >= lengths[:, None]] = 20
    want = _np(jenv.log_reward(jenv.terminal_state_from_tokens(
        jnp.asarray(tokens), jnp.asarray(lengths)), jp))
    got = tenv.log_reward(tenv.terminal_state_from_tokens(
        torch.from_numpy(tokens), torch.from_numpy(lengths)), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_amp_reward_at_max_len_10_reads_jax_table_of_that_length():
    """With no proxy given, AMP at max_len 10 (the CPU commands' size)
    reads the positional table JAX draws at 10, not the first rows of the
    table drawn at 60: the reward equals JAX's own max_len-10 landscape."""
    jenv = jseq.AMPEnvironment(max_len=AMP_LEN)
    tenv = tseq.AMPEnvironment(max_len=AMP_LEN)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    np.testing.assert_array_equal(
        tp.reward_params["pos"]["pos"].numpy(), _np(jp["pos"]["pos"]))
    rng = np.random.RandomState(2)
    lengths = rng.randint(1, AMP_LEN + 1, size=24).astype(np.int32)
    tokens = rng.randint(0, 20, size=(24, AMP_LEN)).astype(np.int32)
    tokens[np.arange(AMP_LEN)[None] >= lengths[:, None]] = 20
    want = _np(jenv.log_reward(jenv.terminal_state_from_tokens(
        jnp.asarray(tokens), jnp.asarray(lengths)), jp))
    got = tenv.log_reward(tenv.terminal_state_from_tokens(
        torch.from_numpy(tokens), torch.from_numpy(lengths)), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_amp_proxy_refuses_a_length_the_file_does_not_hold():
    with pytest.raises(ValueError, match="write-proxies"):
        AMPRewardModule(max_len=12).init(CPU)


# -- each env step by step on the same actions ----------------------------------

def _amp_pair(max_len=AMP_LEN):
    jenv = jseq.AMPEnvironment(max_len=max_len)
    jp = jenv.init(jax.random.PRNGKey(0))
    proxy = {k: v for k, v in jax.device_get(jp).items() if k != "r_min"}
    tenv = tseq.AMPEnvironment(AMPRewardModule(max_len=max_len, proxy=proxy),
                               max_len=max_len)
    return jenv, jp, tenv, tenv.init(CPU)


def _env_pair(name):
    if name == "bitseq":
        jenv, tenv = JaxBitSeq(n=16, k=4), BitSeqEnvironment(n=16, k=4)
    elif name == "tfbind8":
        jenv, tenv = jseq.TFBind8Environment(), tseq.TFBind8Environment()
    elif name == "qm9":
        jenv, tenv = jseq.QM9Environment(), tseq.QM9Environment()
    else:
        return _amp_pair()
    return jenv, jenv.init(jax.random.PRNGKey(0)), tenv, tenv.init(CPU)


def _same_state(js, ts, what):
    import dataclasses
    for f in dataclasses.fields(ts):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      _np(getattr(js, f.name)),
                                      err_msg=f"{what}: {f.name}")


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), _np(j), err_msg=what)


@pytest.mark.parametrize("name", ["bitseq", "tfbind8", "qm9", "amp"])
def test_env_steps_match_jax(name):
    """Random legal actions forward to the terminal (AMP stops early at
    random), then random legal backward actions to the initial state:
    states, observations, masks, rewards, ``get_backward_action``,
    ``get_forward_action`` and ``observe_last`` equal JAX's bitwise (the
    log-rewards to 1e-6)."""
    jenv, jp, tenv, tp = _env_pair(name)
    assert (tenv.action_dim, tenv.backward_action_dim, tenv.max_steps) == \
        (jenv.action_dim, jenv.backward_action_dim, jenv.max_steps)
    rng = np.random.RandomState(0)
    B = 8
    jstep = jax.jit(lambda s, a: jenv.step(s, a, jp)[1:4])
    jback = jax.jit(lambda s, a: jenv.backward_step(s, a, jp)[1:4])
    _, js = jenv.reset(B, jp)
    _, ts = tenv.reset(B, tp)
    prev = np.zeros(B, np.int64)
    cached = getattr(tenv, "supports_incremental_obs", False)
    for t in range(tenv.max_steps):
        what = f"{name} forward t {t}"
        _eq(tenv.observe(ts, tp), jenv.observe(js, jp), what)
        mask = tenv.forward_mask(ts, tp)
        _eq(mask, jenv.forward_mask(js, jp), what)
        _eq(tenv.backward_mask(ts, tp), jenv.backward_mask(js, jp), what)
        if cached:
            for a, b in zip(tenv.observe_last(ts, tp, torch.from_numpy(prev)),
                            jenv.observe_last(js, jp, jnp.asarray(prev))):
                _eq(a, b, what + " observe_last")
        m = mask.numpy()
        act = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                        for r in m])
        if name == "amp":   # stop early on about a quarter of the rows
            stop_ok = m[:, -1] & (rng.rand(B) < 0.25)
            act = np.where(stop_ok, tenv.stop_action, act)
        jn, jr, jd = jstep(js, jnp.asarray(act, jnp.int32))
        _, tn, tr, td = tenv.step(ts, torch.from_numpy(act), tp)
        _same_state(jn, tn, what)
        np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=1e-6, atol=0,
                                   err_msg=what)
        _eq(td, jd, what)
        _eq(tenv.get_backward_action(ts, torch.from_numpy(act), tn, tp),
            jenv.get_backward_action(js, jnp.asarray(act, jnp.int32), jn,
                                     jp), what)
        js, ts, prev = jn, tn, act
    assert tenv.is_terminal(ts, tp).all()
    if name == "amp":
        assert len(set(ts.length.tolist())) > 1
    for t in range(tenv.max_steps):
        what = f"{name} backward t {t}"
        bmask = tenv.backward_mask(ts, tp)
        _eq(bmask, jenv.backward_mask(js, jp), what)
        _eq(tenv.is_initial(ts, tp), jenv.is_initial(js, jp), what)
        b = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                      for r in bmask.numpy()])
        jprev, _, jinit = jback(js, jnp.asarray(b, jnp.int32))
        _, tprev, _, tinit = tenv.backward_step(ts, torch.from_numpy(b), tp)
        _same_state(jprev, tprev, what)
        _eq(tinit, jinit, what)
        _eq(tenv.get_forward_action(ts, torch.from_numpy(b), tprev, tp),
            jenv.get_forward_action(js, jnp.asarray(b, jnp.int32), jprev,
                                    jp), what)
        js, ts = jprev, tprev
    assert tenv.is_initial(ts, tp).all()


def test_terminal_state_constructors_match_jax():
    rng = np.random.RandomState(2)
    jb, tb = JaxBitSeq(n=16, k=4), BitSeqEnvironment(n=16, k=4)
    words = rng.randint(0, 16, size=(5, 4)).astype(np.int32)
    _same_state(jb.terminal_state_from_words(jnp.asarray(words)),
                tb.terminal_state_from_words(torch.from_numpy(words)),
                "bitseq words")
    for jenv, tenv, n in ((jseq.TFBind8Environment(),
                           tseq.TFBind8Environment(), 4 ** 8),
                          (jseq.QM9Environment(), tseq.QM9Environment(),
                           11 ** 5)):
        idx = rng.randint(0, n, size=7)
        js = jenv.terminal_state_from_flat_index(jnp.asarray(idx))
        ts = tenv.terminal_state_from_flat_index(torch.from_numpy(idx))
        _same_state(js, ts, type(tenv).__name__)
        _eq(tenv.flat_terminal_index(ts, None),
            jenv.flat_terminal_index(js, None), "flat index")


# -- the cached AMP rollout with early stops -----------------------------------

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

# -- metrics -----------------------------------------------------------------------

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


def _seq_policy_pair(name, seed=2):
    jenv, jp, tenv, tp = _env_pair(name)
    L = getattr(tenv, "max_len", getattr(tenv, "length", None))
    arch = "pooled" if name == "qm9" else "decode"
    jpol = make_transformer_policy(jenv.vocab_size, L, jenv.action_dim,
                                   jenv.backward_action_dim, arch=arch,
                                   **SMALL)
    jparams = jax.jit(jpol.init)(jax.random.PRNGKey(seed))
    tpol = TransformerPolicy(tenv.vocab_size, L, tenv.action_dim, arch=arch,
                             device=CPU, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jp, jpol, jparams), (tenv, tp, tpol)



# -- the bitseq exact DP --------------------------------------------------------

def _bitseq_policies(n, k, seed=1):
    jenv = JaxBitSeq(n=n, k=k)
    jpol = make_transformer_policy(jenv.vocab_size, jenv.L, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **SMALL)
    jparams = jax.jit(jpol.init)(jax.random.PRNGKey(seed))
    tenv = BitSeqEnvironment(n=n, k=k)
    tpol = TransformerPolicy(tenv.vocab_size, tenv.L, tenv.action_dim,
                             device=CPU, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jparams), \
        (tenv, tenv.init(CPU), tpol)


@pytest.mark.parametrize("n,k", [(8, 4), (8, 2)])
def test_bitseq_dp_matches_jax(n, k):
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _bitseq_policies(n, k)
    want = _np(jax_bitseq_dp(jenv, jp, jpol.apply)(jparams))
    got = make_bitseq_dp(tenv, tp, tpol)().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got.sum() - 1) < 1e-5
    np.testing.assert_array_equal(make_exact_dp(tenv, tp, tpol)().numpy(),
                                  got)


if __name__ == "__main__" and "--write-proxies" in sys.argv[1:]:
    write_proxies()
    print(f"wrote {PROXIES}")
    sys.exit(0)
