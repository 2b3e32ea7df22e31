"""The port's sequence environments, rewards and metrics against the JAX
package's: bitseq's backward steps and flip test set, TFBind8, QM9 and AMP
step by step on the same actions, their rewards and enumerable targets,
the proxies carried across from JAX.  The cached AMP rollout with early
stops, the correlation metrics, top-k reward and diversity, and the bitseq
exact DP are held in ``tests/test_torch_seqs_rollouts.py``, the evaluators
in ``tests/test_torch_seqs_evals.py`` and ``tests/test_torch_seqs_probe.py``.

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
from repro.rewards.amp import AMPRewardModule as JaxAMPReward  # noqa: E402
from repro.rewards.bitseq import make_test_set as jax_make_test_set  # noqa: E402
from repro.rewards.qm9 import QM9RewardModule as JaxQM9Reward  # noqa: E402
from repro.rewards.tfbind8 import synth_binding_table as jax_table  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
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
        AMPRewardModule(max_len=13).init(CPU)


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


# -- policies shared with the rollout and eval tests -------------------------

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


if __name__ == "__main__" and "--write-proxies" in sys.argv[1:]:
    write_proxies()
    print(f"wrote {PROXIES}")
    sys.exit(0)
