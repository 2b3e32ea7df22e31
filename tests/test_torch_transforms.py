"""The port's env transforms against the JAX package's
(``repro.envs.transforms``), on the same states.

- RewardExponent's scheduled beta at iterations 0, mid-anneal and past it:
  float32, bitwise (the port divides by a tensor, as JAX's traced step).
- RewardCache tables and lookups on tfbind8, qm9, the 2x6 hypergrid and
  bitseq (16, 4): tables within 1e-5 (relative and absolute; qm9's proxy
  MLP runs in another library), lookups equal to the port's own table
  entries bitwise and to JAX's within the same 1e-5.
- TimeLimit masks on the 2x6 hypergrid and AMP at max_len 12 (limit 8):
  bitwise, on seeded random states.
- ``parse_transform`` and its errors, the stack helpers, and the refusals
  (a scheduled stack inside a cache, the Box, a full-width bitseq).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs import sequences as jseq  # noqa: E402
from repro.envs import transforms as jtr  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.envs.hypergrid import HypergridState as JaxHGState  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxHGReward  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.envs import transforms as ttr  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.envs.box import BoxEnvironment  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.envs.hypergrid import HypergridState  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(x)


def _jax_state(cls, tstate):
    return cls(**{k: jnp.asarray(v.numpy())
                  for k, v in vars(tstate).items()})


def _hypergrid_pair():
    return (JaxHypergrid(JaxHGReward(), dim=2, side=6),
            HypergridEnvironment(HypergridRewardModule(), dim=2, side=6))


# -- RewardExponent's schedule --------------------------------------------------

@pytest.mark.parametrize("anneal", [40, 7])
def test_scheduled_beta_is_jax_bitwise(anneal):
    jenv, tenv = _hypergrid_pair()
    jt = jtr.RewardExponent(jenv, beta=1.0, final_beta=2.3,
                            anneal_steps=anneal)
    tt = ttr.RewardExponent(tenv, beta=1.0, final_beta=2.3,
                            anneal_steps=anneal)
    jp, tp = jt.init(jax.random.PRNGKey(0)), tt.init(CPU)
    assert jt.scheduled and tt.scheduled
    assert _np(jp.extra["beta"]) == tp.extra["beta"].numpy()
    for it in (0, 1, 3, anneal // 2, anneal - 1, anneal, anneal + 17):
        jb = _np(jt.update_params(jp, jnp.int32(it)).extra["beta"])
        tb = tt.update_params(tp, torch.tensor(it)).extra["beta"].numpy()
        assert jb.dtype == tb.dtype == np.float32
        assert jb.tobytes() == tb.tobytes(), (it, jb, tb)
    past = tt.update_params(tp, torch.tensor(anneal + 17))
    assert float(past.extra["beta"]) == np.float32(2.3)


def test_constant_beta_scales_rewards_as_jax():
    jenv, tenv = _hypergrid_pair()
    jt, tt = jtr.RewardExponent(jenv, beta=2.0), \
        ttr.RewardExponent(tenv, beta=2.0)
    jp, tp = jt.init(jax.random.PRNGKey(0)), tt.init(CPU)
    assert not tt.scheduled
    # update_params keeps a constant beta's tensor
    assert tt.update_params(tp, torch.tensor(5)).extra["beta"] is \
        tp.extra["beta"]
    np.testing.assert_allclose(tt.true_log_rewards(tp).numpy(),
                               _np(jt.true_log_rewards(jp)), **TOL)
    np.testing.assert_allclose(tt.true_distribution(tp).numpy(),
                               _np(jt.true_distribution(jp)), **TOL)


# -- RewardCache ----------------------------------------------------------------

def _cache_pairs():
    return {
        "tfbind8": (jseq.TFBind8Environment(), tseq.TFBind8Environment()),
        "qm9": (jseq.QM9Environment(), tseq.QM9Environment()),
        "hypergrid": _hypergrid_pair(),
        "bitseq": (JaxBitSeq(n=16, k=4), BitSeqEnvironment(n=16, k=4)),
    }


@pytest.mark.parametrize("name,size", [("tfbind8", 65536), ("qm9", 161051),
                                       ("hypergrid", 36),
                                       ("bitseq", 65536)])
def test_reward_cache_tables_and_lookups_match_jax(name, size):
    jenv, tenv = _cache_pairs()[name]
    jc, tc = jtr.RewardCache(jenv), ttr.RewardCache(tenv)
    jp, tp = jc.init(jax.random.PRNGKey(0)), tc.init(CPU)
    table = tp.extra["table"]
    assert table.shape == (size,) and table.dtype == torch.float32
    np.testing.assert_allclose(table.numpy(), _np(jp.extra["table"]), **TOL)
    # lookups on seeded terminal states, through flat_terminal_index
    idx = np.random.RandomState(size % 97).randint(0, size, 64)
    tstate = tenv.terminal_state_from_flat_index(torch.as_tensor(idx))
    got = tc.log_reward(tstate, tp)
    assert torch.equal(got, table[torch.as_tensor(idx)])
    assert torch.equal(tc.flat_terminal_index(tstate, tp),
                       torch.as_tensor(idx))
    jstate = jenv.terminal_state_from_flat_index(jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(got.numpy(), _np(jc.log_reward(jstate, jp)),
                               **TOL)
    # the cache's lookups are the bare env's rewards
    np.testing.assert_allclose(got.numpy(),
                               tenv.log_reward(tstate, tp.inner).numpy(),
                               **TOL)


def test_bitseq_enumeration_matches_jax():
    jenv, tenv = JaxBitSeq(n=16, k=4), BitSeqEnvironment(n=16, k=4)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    assert tenv.num_terminal_states == jenv.num_terminal_states == 16 ** 4
    np.testing.assert_allclose(tenv.true_distribution(tp).numpy(),
                               _np(jenv.true_distribution(jp)), rtol=1e-4,
                               atol=1e-9)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, 17, (32, 4)).astype(np.int32)   # 16 = empty
    state = tenv.terminal_state_from_words(torch.as_tensor(tokens))
    jstate = jenv.terminal_state_from_words(jnp.asarray(tokens))
    np.testing.assert_array_equal(
        tenv.flat_terminal_index(state, tp).numpy(),
        _np(jenv.flat_terminal_index(jstate, jp)))


# -- TimeLimit ------------------------------------------------------------------

def _hypergrid_states(B=96, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, 6, (B, 2)).astype(np.int32)
    terminal = rng.rand(B) < 0.2
    steps = (pos.sum(-1) + terminal).astype(np.int32)
    return HypergridState(pos=torch.as_tensor(pos),
                          terminal=torch.as_tensor(terminal),
                          steps=torch.as_tensor(steps))


def _amp_states(max_len=12, B=96, seed=1):
    rng = np.random.RandomState(seed)
    length = rng.randint(0, max_len + 1, B).astype(np.int32)
    tokens = np.full((B, max_len), 20, np.int32)
    for b in range(B):
        tokens[b, :length[b]] = rng.randint(0, 20, length[b])
    stopped = (rng.rand(B) < 0.3) & (length >= 1)
    steps = (length + stopped).astype(np.int32)
    return tseq.SeqState(tokens=torch.as_tensor(tokens),
                         length=torch.as_tensor(length),
                         steps=torch.as_tensor(steps),
                         stopped=torch.as_tensor(stopped))


@pytest.mark.parametrize("case", ["hypergrid", "amp"])
def test_time_limit_masks_match_jax(case):
    if case == "hypergrid":
        jenv, tenv = _hypergrid_pair()
        jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
        state = _hypergrid_states()
        jstate = _jax_state(JaxHGState, state)
    else:
        # the masks read no params; AMP at 12 has no proxy table
        jenv, tenv = jseq.AMPEnvironment(max_len=12), \
            tseq.AMPEnvironment(max_len=12)
        jp = tp = None
        state = _amp_states()
        jstate = _jax_state(jseq.SeqState, state)
    jt, tt = jtr.TimeLimit(jenv, limit=8), ttr.TimeLimit(tenv, limit=8)
    assert tt.max_steps == jt.max_steps == 8
    got = tt.forward_mask(state, tp)
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jt.forward_mask(jstate, jp)))
    forced = state.steps.numpy() >= 7
    assert forced.any() and (~forced).any()
    only_stop = np.zeros(tenv.action_dim, bool)
    only_stop[tenv.stop_action] = True
    assert not got.numpy()[forced][:, ~only_stop].any()
    # a limit at or above the horizon leaves the masks alone
    long = ttr.TimeLimit(tenv, limit=100)
    assert long.max_steps == tenv.max_steps
    assert torch.equal(long.forward_mask(state, tp),
                       tenv.forward_mask(state, tp))


# -- specs, stacks, refusals ----------------------------------------------------

@pytest.mark.parametrize("spec", [
    "beta=2.0", "reward_cache", "identity", " time_limit:limit=8 ",
    "reward_exponent:beta=1.0,final_beta=2.0,anneal_steps=40",
    "reward_exponent: beta = 0.5 ,", "time_limit:limit=abc"])
def test_parse_transform_matches_jax(spec):
    assert ttr.parse_transform(spec) == jtr.parse_transform(spec)


@pytest.mark.parametrize("spec,exc", [("nope", KeyError),
                                      ("nope:beta=1", KeyError),
                                      ("reward_exponent:beta", ValueError),
                                      ("time_limit:8", ValueError)])
def test_parse_transform_errors_match_jax(spec, exc):
    with pytest.raises(exc):
        jtr.parse_transform(spec)
    with pytest.raises(exc):
        ttr.parse_transform(spec)


def test_registry_of_transforms_and_stack_helpers():
    assert sorted(ttr.TRANSFORMS) == sorted(jtr.TRANSFORMS)
    _, tenv = _hypergrid_pair()
    env = ttr.apply_transforms(tenv, ["reward_cache", "time_limit:limit=5",
                                      lambda e: ttr.RewardExponent(e, 0.5)])
    assert ttr.transform_stack(env) == ("reward_exponent", "time_limit",
                                        "reward_cache")
    assert ttr.base_env(env) is tenv
    assert not ttr.has_scheduled_reward(env)
    sched = ttr.apply_transforms(tenv, [
        "reward_exponent:beta=1.0,final_beta=2.0,anneal_steps=4",
        "time_limit:limit=5"])
    assert ttr.has_scheduled_reward(sched)
    # helpers and params fall through the layers
    p = env.init(CPU)
    assert env.side == 6 and env.flatten_index == tenv.flatten_index
    assert p.device == CPU and p.inner.inner.dim == 2
    _, s0 = env.reset(3, p)
    assert s0.pos.shape == (3, 2)


def test_refusals_match_jax():
    jenv, tenv = _hypergrid_pair()
    for tr, env in ((jtr, jenv), (ttr, tenv)):
        sched = tr.RewardExponent(env, beta=1.0, final_beta=2.0,
                                  anneal_steps=4)
        with pytest.raises(TypeError, match="scheduled"):
            tr.RewardCache(sched)
        with pytest.raises(ValueError, match="final_beta"):
            tr.RewardExponent(env, final_beta=2.0)
        with pytest.raises(ValueError, match="limit must be"):
            tr.TimeLimit(env, limit=0)
    # the Box has no enumeration surface; bitseq has no stop action
    with pytest.raises(TypeError, match="enumeration surface"):
        ttr.RewardCache(BoxEnvironment())
    with pytest.raises(TypeError, match="stop action"):
        ttr.TimeLimit(BitSeqEnvironment(n=16, k=4), limit=2)
    with pytest.raises(ValueError, match="only allows"):
        ttr.TimeLimit(tseq.AMPEnvironment(max_len=12), limit=1)
    # full-width bitseq (2^120 terminals) refuses at max_states, as JAX
    full = ttr.RewardCache(BitSeqEnvironment())
    with pytest.raises(ValueError, match="terminal states"):
        full.init(CPU)
    with pytest.raises(ValueError, match="terminal states"):
        jtr.RewardCache(JaxBitSeq()).init(jax.random.PRNGKey(0))
