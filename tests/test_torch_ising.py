"""The port's Ising environment and collecting backward rollout against
the JAX package's: the lattice, both MCMC samplers' datasets (bitwise),
the env's steps, masks, backward removal, action maps, reward and energy,
and ``backward_rollout(collect=True)`` field by field on the Ising env and
on the hypergrid, with and without log P_F and with a known log-reward.

Noise: a source that replays JAX's draws (env e at step t folds
``split(key, T)[t]`` with e and draws the Gumbel noise from the middle of
the three keys ``sample_masked`` splits it into).

Tolerances (fp32 on both sides, other reduction orders): lattices,
datasets, states, masks, actions and flags bitwise; log R, energies and
log-probs to 1e-5 relative with 1e-5 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.rollout import backward_rollout as jax_backward  # noqa: E402
from repro.envs import ising as jising  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxGrid  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.rollout import (backward_rollout,  # noqa: E402
                                      forward_rollout)
from repro_torch.envs import ising as tising  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.recipes import ising as ising_recipe  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 8
RTOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(x)


def _pair(n=3, sigma=-0.1):
    jenv = jising.IsingEnvironment(n=n, sigma=sigma)
    tenv = tising.IsingEnvironment(n=n, sigma=sigma)
    return jenv, jenv.init(jax.random.PRNGKey(0)), tenv, tenv.init(CPU)


def _random_J(D, seed):
    J = np.random.RandomState(seed).randn(D, D).astype(np.float32) * 0.3
    return (J + J.T) * np.float32(0.5)


# -- the lattice and the datasets ------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 9])
def test_toroidal_adjacency_and_true_J_are_bitwise_jax(n):
    np.testing.assert_array_equal(tising.toroidal_adjacency(n),
                                  jising.toroidal_adjacency(n))
    for sigma in (-0.1, 0.2):
        jenv, jp, _, tp = _pair(n, sigma)
        assert tp.reward_params["J"].dtype == torch.float32
        np.testing.assert_array_equal(tp.reward_params["J"].numpy(),
                                      _np(jp["J"]))


@pytest.mark.parametrize("seed", [0, 3])
def test_wolff_dataset_is_bitwise_jax(seed):
    """The Wolff sampler (ferromagnetic sigma) at the JAX test's size
    (``tests/test_envs.py``: n = 4, sigma = 0.5, 50 samples)."""
    got = tising.generate_ising_dataset(seed, 4, 0.5, 50)
    assert got.dtype == np.int8 and got.shape == (50, 16)
    np.testing.assert_array_equal(
        got, jising.generate_ising_dataset(seed, 4, 0.5, 50))


@pytest.mark.parametrize("n,sigma,num,seed", [(3, -0.1, 12, 0),
                                              (4, -0.3, 4, 5)])
def test_parallel_tempering_dataset_is_bitwise_jax(n, sigma, num, seed):
    """The heat-bath parallel-tempering sampler (the recipe's, sigma < 0)."""
    got = tising.generate_ising_dataset(seed, n, sigma, num)
    assert got.dtype == np.int8 and got.shape == (num, n * n)
    np.testing.assert_array_equal(
        got, jising.generate_ising_dataset(seed, n, sigma, num))


def test_recipe_dataset_is_made_once_and_copied():
    a = ising_recipe.ising_dataset(0, 3, -0.1, 6)
    a[:] = 0
    np.testing.assert_array_equal(
        ising_recipe.ising_dataset(0, 3, -0.1, 6),
        jising.generate_ising_dataset(0, 3, -0.1, 6))


# -- the environment ---------------------------------------------------------------

def test_forward_mask_repeats_each_site_twice():
    """Action 2 * site + b is legal where the site is unassigned: at a
    partial state the mask holds each site's flag twice in a row (a tiled
    mask would not)."""
    _, _, tenv, tp = _pair()
    _, s = tenv.reset(1, tp)
    _, s, _, _ = tenv.step(s, torch.tensor([2 * 1 + 1]), tp)    # site 1 up
    mask = tenv.forward_mask(s, tp)[0]
    assert mask.tolist() == [True, True, False, False] + [True] * 14
    assert int(s.spins[0, 1]) == 1 and s.spins.dtype == torch.int8


def test_steps_masks_reward_and_energy_match_jax():
    """D forward steps with random legal actions from s0, then D backward
    steps back to s0: states, masks, observations, done flags and both
    action maps bitwise at every partial state; log R and the energy to
    1e-5 under the true J and under a random symmetric J."""
    jenv, jp, tenv, tp = _pair()
    J = _random_J(tenv.D, 3)
    params = [(jp, tp), ({"J": jnp.asarray(J)},
                         tising.IsingParams({"J": torch.from_numpy(J)}))]
    rng = np.random.RandomState(0)
    n = 16
    _, js = jenv.reset(n, jp)
    _, ts = tenv.reset(n, tp)

    def same(what):
        np.testing.assert_array_equal(ts.spins.numpy(), _np(js.spins),
                                      err_msg=what)
        np.testing.assert_array_equal(ts.steps.numpy(), _np(js.steps),
                                      err_msg=what)
        assert ts.spins.dtype == torch.int8 and ts.steps.dtype == torch.int32
        for f in ("forward_mask", "backward_mask", "observe", "is_terminal",
                  "is_initial"):
            np.testing.assert_array_equal(
                getattr(tenv, f)(ts, tp).numpy(),
                _np(getattr(jenv, f)(js, jp)), err_msg=f"{what} {f}")
        for jparams, tparams in params:
            for f in ("log_reward", "energy"):
                np.testing.assert_allclose(
                    getattr(tenv, f)(ts, tparams).numpy(),
                    _np(getattr(jenv, f)(js, jparams)), err_msg=f"{what} {f}",
                    **RTOL)

    for t in range(tenv.max_steps):
        same(f"forward {t}")
        a = np.array([rng.choice(np.flatnonzero(m))
                      for m in _np(jenv.forward_mask(js, jp))])
        _, jn, _, _, _ = jenv.step(js, jnp.asarray(a, jnp.int32), jp)
        _, tn, _, _ = tenv.step(ts, torch.as_tensor(a), tp)
        back = tenv.get_backward_action(ts, torch.as_tensor(a), tn, tp)
        assert back.dtype == torch.int64
        np.testing.assert_array_equal(back.numpy(), _np(
            jenv.get_backward_action(js, jnp.asarray(a), jn, jp)))
        js, ts = jn, tn
    same("terminal")
    term = tenv.terminal_state_from_spins(ts.spins.to(torch.int32))
    jterm = jenv.terminal_state_from_spins(js.spins)
    np.testing.assert_array_equal(term.spins.numpy(), _np(jterm.spins))
    np.testing.assert_array_equal(term.steps.numpy(), _np(jterm.steps))
    assert term.spins.dtype == torch.int8
    for t in range(tenv.max_steps):
        a = np.array([rng.choice(np.flatnonzero(m))
                      for m in _np(jenv.backward_mask(js, jp))])
        _, jn, _, _, _ = jenv.backward_step(js, jnp.asarray(a, jnp.int32), jp)
        _, tn, _, _ = tenv.backward_step(ts, torch.as_tensor(a), tp)
        fwd = tenv.get_forward_action(ts, torch.as_tensor(a), tn, tp)
        assert fwd.dtype == torch.int64
        np.testing.assert_array_equal(fwd.numpy(), _np(
            jenv.get_forward_action(js, jnp.asarray(a, jnp.int32), jn, jp)))
        js, ts = jn, tn
        same(f"backward {t}")
    assert bool(tenv.is_initial(ts, tp).all())
    # at an initial state the spin under any site is 0: forward action 2a
    zero = torch.zeros(n, dtype=torch.int64)
    np.testing.assert_array_equal(
        tenv.get_forward_action(ts, zero + 4, ts, tp).numpy(),
        _np(jenv.get_forward_action(js, jnp.full((n,), 4, jnp.int32), js,
                                    jp)))


# -- the collecting backward rollout ---------------------------------------------

@jax.jit
def _gumbel_rows(key, ids, ts, shape_ta):
    """The categorical draw (``key_c``) of env ids[r] at step ts[r] of a
    non-exploring rollout keyed ``key`` over T steps (forward and backward
    rollouts fold alike)."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        _, key_c, _ = jax.random.split(jax.random.fold_in(step_keys[t], i), 3)
        return jax.random.gumbel(key_c, (A,))

    return jax.vmap(one)(ids, ts)


def replay_gumbel(key, T):
    """A noise source replaying JAX's Gumbel draws of a rollout keyed
    ``key`` over T steps."""
    def noise(seed, index, t, num_actions):
        return torch.from_numpy(_np(_gumbel_rows(
            key, jnp.asarray(index.numpy(), jnp.int32),
            jnp.asarray(t.numpy(), jnp.int32), jnp.zeros((T, num_actions)))))
    return noise


FIELDS_EXACT = ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
                "valid", "done")
FIELDS_CLOSE = ("log_reward", "log_r_state", "energy", "log_pf_beh")


def assert_batch_matches_jax(tb, jb, what=""):
    for name in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      _np(getattr(jb, name)),
                                      err_msg=f"{what} {name}")
    for name in FIELDS_CLOSE:
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   _np(getattr(jb, name)),
                                   err_msg=f"{what} {name}", **RTOL)


def _ising_case():
    jenv, _, tenv, _ = _pair()
    J = _random_J(tenv.D, 1)
    jp = {"J": jnp.asarray(J)}
    tp = tising.IsingParams({"J": torch.from_numpy(J)})
    spins = jising.generate_ising_dataset(0, 3, -0.1, B)
    return (jenv, jp, jenv.terminal_state_from_spins(jnp.asarray(spins)),
            tenv, tp, tenv.terminal_state_from_spins(torch.from_numpy(spins)))


def _grid_case():
    jenv, tenv = JaxGrid(dim=2, side=4), HypergridEnvironment(dim=2, side=4)
    idx = np.random.RandomState(2).randint(0, 16, B)
    idx[:2] = 0                  # the origin's terminal: a 1-step trajectory
    return (jenv, jenv.init(jax.random.PRNGKey(0)),
            jenv.terminal_state_from_flat_index(jnp.asarray(idx)),
            tenv, tenv.init(CPU),
            tenv.terminal_state_from_flat_index(torch.as_tensor(idx)))


CASES = {"ising": _ising_case, "hypergrid": _grid_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jenv, jp, jterm, tenv, tp, tterm = CASES[request.param]()
    obs_dim = tenv.observe(tterm, tp).shape[-1]
    jpol = make_mlp_policy(obs_dim, tenv.action_dim, tenv.backward_action_dim,
                           hidden=(32, 32), learn_backward=True)
    jparams = jpol.init(jax.random.PRNGKey(4))
    tpol = MLPPolicy(obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=(32, 32), learn_backward=True, device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return dict(name=request.param, jenv=jenv, jp=jp, jterm=jterm,
                tenv=tenv, tp=tp, tterm=tterm, jpol=jpol, jparams=jparams,
                tpol=tpol)


@pytest.mark.parametrize("with_log_pf,known", [(True, False), (False, False),
                                               (True, True)])
def test_collecting_backward_rollout_matches_jax(case, with_log_pf, known):
    """Every field of the forward-ordered batch, its dtypes those of
    ``forward_rollout``'s, and the log P_F / log P_B totals."""
    key = jax.random.PRNGKey(11)
    known_r = np.linspace(-2.0, 3.0, B).astype(np.float32) if known \
        else None
    jbr = jax.jit(lambda p, term: jax_backward(
        key, case["jenv"], case["jp"], case["jpol"], p, term, collect=True,
        with_log_pf=with_log_pf,
        known_log_reward=None if known_r is None else jnp.asarray(known_r)))(
        case["jparams"], case["jterm"])
    tbr = backward_rollout(
        0, case["tenv"], case["tp"], case["tpol"], case["tterm"],
        noise=replay_gumbel(key, case["tenv"].max_steps), collect=True,
        with_log_pf=with_log_pf,
        known_log_reward=None if known_r is None else torch.from_numpy(
            known_r))
    what = f"{case['name']} with_log_pf={with_log_pf} known={known}"
    assert_batch_matches_jax(tbr.batch, jbr.batch, what)
    np.testing.assert_allclose(tbr.log_pf.numpy(), _np(jbr.log_pf),
                               err_msg=what, **RTOL)
    np.testing.assert_allclose(tbr.log_pb.numpy(), _np(jbr.log_pb),
                               err_msg=what, **RTOL)
    if not with_log_pf:
        assert not tbr.log_pf.any() and not tbr.batch.log_pf_beh.any()
    if known:
        np.testing.assert_array_equal(tbr.batch.log_reward.numpy(), known_r)
    fwd = forward_rollout(0, case["tenv"], case["tp"], case["tpol"], B)
    for f in FIELDS_EXACT + FIELDS_CLOSE:
        assert getattr(tbr.batch, f).dtype == getattr(fwd, f).dtype, f
        assert getattr(tbr.batch, f).shape == getattr(fwd, f).shape, f
    if case["name"] == "hypergrid":
        # rows from the origin are padded at their start: one valid step
        assert tbr.batch.valid[:, 0].sum() == 1
        assert tbr.batch.valid[-1, 0] and not tbr.batch.valid[:-1, 0].any()
    else:
        assert tbr.batch.energy.any()


def test_collect_leaves_the_totals_bitwise(case):
    """Collecting records the trajectory and changes none of its
    arithmetic: the totals equal the non-collecting rollout's."""
    args = (5, case["tenv"], case["tp"], case["tpol"], case["tterm"])
    a = backward_rollout(*args)
    b = backward_rollout(*args, collect=True)
    assert a.batch is None
    assert torch.equal(a.log_pf, b.log_pf) and torch.equal(a.log_pb, b.log_pb)
    # its batch teacher-forces to the same log P_F
    logp = torch.where(b.batch.valid, b.batch.log_pf_beh, 0.0).sum(0)
    torch.testing.assert_close(logp, b.log_pf, rtol=1e-6, atol=1e-6)
