"""The port's hypergrid env and reward against the JAX package's, bit for
bit (one ulp at R = 2.6 of the easy reward, where XLA's log is off by one):
reward, masks, forward and backward steps over random legal action
sequences (numpy seed), ``flatten_index`` and
``terminal_state_from_flat_index``, on 2x5, 3x4 and 4x8 grids.  The exact
target R(x)/Z is a softmax, summed in another order: 1e-5 relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import (  # noqa: E402
    EasyHypergridRewardModule as JaxEasy,
    HypergridRewardModule as JaxReward)
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.rewards.hypergrid import (  # noqa: E402
    EasyHypergridRewardModule, HypergridRewardModule)

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRIDS = [(2, 5), (3, 4), (4, 8)]
REWARDS = [(JaxReward, HypergridRewardModule),
           (JaxEasy, EasyHypergridRewardModule)]


def _np(x):
    return np.array(x)


def _pair(dim, side, reward=0):
    jr, tr = REWARDS[reward]
    jenv = JaxHypergrid(jr(), dim=dim, side=side)
    tenv = HypergridEnvironment(tr(), dim=dim, side=side)
    return (jenv, jenv.init(jax.random.PRNGKey(0))), (tenv, tenv.init(CPU))


def _assert_state(ts, js):
    for name in ("pos", "terminal", "steps"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      _np(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("reward", [0, 1])
@pytest.mark.parametrize("dim,side", GRIDS)
def test_reward_and_target_match_jax_bitwise(dim, side, reward):
    (jenv, jp), (tenv, tp) = _pair(dim, side, reward)
    assert (tenv.action_dim, tenv.backward_action_dim, tenv.max_steps,
            tenv.obs_dim, tenv.stop_action) == (
        jenv.action_dim, jenv.backward_action_dim, jenv.max_steps,
        jenv.obs_dim, jenv.stop_action)
    got, want = tenv.true_log_rewards(tp).numpy(), \
        _np(jenv.true_log_rewards(jp))
    if reward == 0:
        np.testing.assert_array_equal(got, want)
    else:
        # R = 2.6 occurs only here: XLA's CPU log rounds log(2.6) one ulp
        # off the correctly rounded float32, which torch's log gives
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        other = ~np.isclose(want, np.log(2.6), rtol=1e-6)
        np.testing.assert_array_equal(got[other], want[other])
    # the softmax sums up to 4,096 fp32 terms in another order
    np.testing.assert_allclose(tenv.true_distribution(tp).numpy(),
                               _np(jenv.true_distribution(jp)), rtol=1e-5,
                               atol=0)
    assert tenv.num_terminal_states == jenv.num_terminal_states


@pytest.mark.parametrize("dim,side", GRIDS)
def test_flat_index_round_trip_matches_jax(dim, side):
    (jenv, _), (tenv, _) = _pair(dim, side)
    rng = np.random.RandomState(dim * side)
    idx = rng.randint(0, side ** dim, size=64)
    js = jenv.terminal_state_from_flat_index(jnp.asarray(idx, jnp.int32))
    ts = tenv.terminal_state_from_flat_index(torch.from_numpy(idx))
    _assert_state(ts, js)
    np.testing.assert_array_equal(tenv.flatten_index(ts.pos).numpy(), idx)
    np.testing.assert_array_equal(tenv.flatten_index(ts.pos).numpy(),
                                  _np(jenv.flatten_index(js.pos)))
    # the enumeration order is the target's C-order
    all_pos = tenv.all_positions(CPU)
    np.testing.assert_array_equal(tenv.flatten_index(all_pos).numpy(),
                                  np.arange(side ** dim))


@pytest.mark.parametrize("dim,side", GRIDS)
def test_steps_masks_and_rewards_match_jax(dim, side):
    """Random legal forward actions to the end of the trajectory (terminal
    rows take a dummy action), then random legal backward actions back to
    the initial state; every state, mask, observation and reward equal."""
    (jenv, jp), (tenv, tp) = _pair(dim, side)
    B = 8
    rng = np.random.RandomState(side)
    jo, js = jenv.reset(B, jp)
    to, ts = tenv.reset(B, tp)
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    for _ in range(jenv.max_steps):
        fmask = _np(jenv.forward_mask(js, jp))
        np.testing.assert_array_equal(tenv.forward_mask(ts, tp).numpy(),
                                      fmask)
        np.testing.assert_array_equal(tenv.backward_mask(ts, tp).numpy(),
                                      _np(jenv.backward_mask(js, jp)))
        np.testing.assert_array_equal(tenv.is_initial(ts, tp).numpy(),
                                      _np(jenv.is_initial(js, jp)))
        act = np.asarray([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                          for r in fmask], np.int32)
        jo, jn, jr, jd, _ = jenv.step(js, jnp.asarray(act), jp)
        to, tn, tr, td = tenv.step(ts, torch.from_numpy(act).long(), tp)
        _assert_state(tn, jn)
        np.testing.assert_array_equal(to.numpy(), _np(jo))
        assert to.dtype == torch.float32 and to.shape == (B, dim * side)
        np.testing.assert_array_equal(tr.numpy(), _np(jr))
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        np.testing.assert_array_equal(
            tenv.get_backward_action(ts, torch.from_numpy(act), tn,
                                     tp).numpy(),
            _np(jenv.get_backward_action(js, jnp.asarray(act), jn, jp)))
        js, ts = jn, tn
    assert _np(js.terminal).all()
    np.testing.assert_array_equal(tenv.log_reward(ts, tp).numpy(),
                                  _np(jenv.log_reward(js, jp)))
    for _ in range(jenv.max_steps + 1):
        bmask = _np(jenv.backward_mask(js, jp))
        np.testing.assert_array_equal(tenv.backward_mask(ts, tp).numpy(),
                                      bmask)
        act = np.asarray([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                          for r in bmask], np.int32)
        jo, jn, _, jd, _ = jenv.backward_step(js, jnp.asarray(act), jp)
        to, tn, tz, td = tenv.backward_step(ts, torch.from_numpy(act).long(),
                                            tp)
        _assert_state(tn, jn)
        np.testing.assert_array_equal(to.numpy(), _np(jo))
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        assert not tz.any()
        np.testing.assert_array_equal(
            tenv.get_forward_action(ts, torch.from_numpy(act), tn,
                                    tp).numpy(),
            _np(jenv.get_forward_action(js, jnp.asarray(act), jn, jp)))
        js, ts = jn, tn
    assert _np(jenv.is_initial(js, jp)).all()
    assert tenv.is_initial(ts, tp).all()


def test_reward_bands_use_float32_division():
    """x = |pos / (side - 1) - 0.5| in float32: on a 20-grid pos 3 gives
    x = 0.342..., inside the (0.3, 0.4) band; the log-rewards of the
    paper grid equal the JAX package's at every state."""
    (jenv, jp), (tenv, tp) = _pair(4, 20)
    np.testing.assert_array_equal(tenv.true_log_rewards(tp).numpy(),
                                  _np(jenv.true_log_rewards(jp)))
    lr = tenv.reward_module.log_reward(
        torch.tensor([[3, 3, 3, 3], [0, 0, 0, 0], [5, 5, 5, 5]]),
        tp.reward_params)
    np.testing.assert_allclose(
        lr.numpy(), np.log(np.float32([1e-3 + 0.5 + 2.0, 1e-3 + 0.5, 1e-3])),
        rtol=1e-6)
