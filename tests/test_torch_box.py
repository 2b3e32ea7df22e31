"""The port's Box environment, reward, flow policy and flow noise against
the JAX package's: supports, masks, observations, ``obs_fields`` and the
dynamics bitwise; the mixture reward; the squashed-mixture density; the
policy's four density entries from JAX-initialised parameters carried
across; ``sample`` / ``sample_b`` over JAX's draws replayed; the hash
flow noise.

Noise: a source that replays JAX's draws.  Env e at step t of a rollout
keyed ``key`` over T steps folds ``split(key, T)[t]`` with e; a forward
draw splits that key into ``(k_exit, k_mix, k_eps, k_unif)`` and ``k_mix``
into ``(kc, kn)``, a backward draw splits it into ``(kc, kn)`` directly
(``repro/nn/flows.py:211-224``, ``:246``).

Tolerances (fp32 on both sides; ``torch.sigmoid``, ``F.logsigmoid``,
``log_softmax`` and ``logsumexp`` may round other than XLA's by an ulp):
geometry, masks, observations and flags bitwise; log R within 1e-6
(relative and absolute); densities within 1e-5; increments within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs.box import BoxEnvironment as JaxBox  # noqa: E402
from repro.envs.box import BoxState as JaxState  # noqa: E402
from repro.nn import flows as jflows  # noqa: E402
from repro.rewards.box import BoxRewardModule as JaxReward  # noqa: E402
from repro.rewards.box import mixture_log_density as jax_mld  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.types import (FlowNoise, hash_flow_backward_noise,  # noqa: E402
                                    hash_flow_noise)
from repro_torch.envs.box import BoxEnvironment, BoxState  # noqa: E402
from repro_torch.nn import flows as tflows  # noqa: E402
from repro_torch.rewards.box import mixture_log_density  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
DENS = dict(rtol=1e-5, atol=1e-5)
REWARD = dict(rtol=1e-6, atol=1e-6)
DELTAS = [(0.1, 0.25), (0.05, 0.3), (0.2, 0.45)]
HIDDEN, K = (32, 32), 3


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(delta=(0.1, 0.25)):
    jenv = JaxBox(JaxReward(), delta_min=delta[0], delta_max=delta[1])
    tenv = BoxEnvironment(delta_min=delta[0], delta_max=delta[1])
    return jenv, jenv.init(jax.random.PRNGKey(0)), tenv, tenv.init(CPU)


def _states(tenv, n, seed):
    """Seeded states across the square: positions on the staircase, on
    and near the boundary tests, exact multiples of the deltas; steps 0 to
    max_steps; some terminal copies."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    edges = np.float32([0.0, 1.0, tenv.delta_min, 1 - tenv.delta_min,
                        np.float32(1 - tenv.delta_min) + np.float32(1e-6),
                        tenv.delta_max, 0.5])
    pos[: n // 2] = rng.choice(edges, (n // 2, 2))
    steps = rng.randint(0, tenv.max_steps + 1, n).astype(np.int32)
    terminal = rng.rand(n) < 0.3
    return pos, steps, terminal


def _state_pair(pos, steps, terminal):
    return (JaxState(pos=jnp.asarray(pos), terminal=jnp.asarray(terminal),
                     steps=jnp.asarray(steps)),
            BoxState(pos=torch.from_numpy(pos),
                     terminal=torch.from_numpy(terminal),
                     steps=torch.from_numpy(steps)))


# -- geometry and dynamics ----------------------------------------------------

@pytest.mark.parametrize("delta", DELTAS)
def test_supports_masks_and_observations_are_bitwise_jax(delta):
    jenv, jp, tenv, tp = _pair(delta)
    assert tenv.max_steps == jenv.max_steps
    assert tenv.max_increments == jenv.max_increments
    pos, steps, terminal = _states(tenv, 256, 0)
    js, ts = _state_pair(pos, steps, terminal)
    for a, b in zip(tenv.forward_support(ts.pos),
                    jenv.forward_support(js.pos)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(tenv.backward_support(ts.pos, ts.steps),
                    jenv.backward_support(js.pos, js.steps)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for f in ("observe", "forward_mask", "backward_mask", "is_terminal",
              "is_initial"):
        got, want = getattr(tenv, f)(ts, tp), getattr(jenv, f)(js, jp)
        assert got.dtype == (torch.float32 if f == "observe"
                             else torch.bool), f
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=f)
    # obs_fields gives back the state: steps exactly
    obs = tenv.observe(ts, tp)
    p, s, term = tenv.obs_fields(obs)
    jfields = jenv.obs_fields(jenv.observe(js, jp))
    for a, b in zip((p, s, term), jfields):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(s.numpy(), steps)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(term.numpy(), terminal)


@pytest.mark.parametrize("delta", DELTAS)
def test_steps_and_backward_steps_are_bitwise_jax(delta):
    """Forward steps with seeded increments (exits mixed in) to the end,
    then backward steps removing the same increments: states, rewards and
    the identity action maps bitwise at every step."""
    jenv, jp, tenv, tp = _pair(delta)
    rng = np.random.RandomState(1)
    n = 64
    _, js = jenv.reset(n, jp)
    _, ts = tenv.reset(n, tp)
    jstep = jax.jit(lambda s, a: jenv.step(s, a, jp))
    jback = jax.jit(lambda s, a: jenv.backward_step(s, a, jp))
    taken = []

    def same(what):
        for f in ("pos", "terminal", "steps"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          _np(getattr(js, f)),
                                          err_msg=f"{what} {f}")
        np.testing.assert_array_equal(tenv.observe(ts, tp).numpy(),
                                      _np(jenv.observe(js, jp)), err_msg=what)

    for t in range(tenv.max_steps):
        u = rng.uniform(tenv.delta_min, tenv.delta_max, (n, 2))
        ex = (rng.rand(n) < 0.15) | (t == tenv.max_steps - 1)
        a = np.concatenate([u, ex[:, None]], 1).astype(np.float32)
        _, jn, jr, jd, _ = jstep(js, jnp.asarray(a))
        _, tn, tr, td = tenv.step(ts, torch.from_numpy(a), tp)
        np.testing.assert_allclose(tr.numpy(), _np(jr), **REWARD)
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        back = tenv.get_backward_action(ts, torch.from_numpy(a), tn, tp)
        np.testing.assert_array_equal(back.numpy(), a)
        taken.append(a)
        js, ts = jn, tn
        same(f"forward {t}")
    for t, a in enumerate(reversed(taken)):
        _, jn, _, _, _ = jback(js, jnp.asarray(a))
        _, tn, _, _ = tenv.backward_step(ts, torch.from_numpy(a), tp)
        fwd = tenv.get_forward_action(ts, torch.from_numpy(a), tn, tp)
        np.testing.assert_array_equal(fwd.numpy(), a)
        js, ts = jn, tn
        same(f"backward {t}")


def test_invalid_deltas_raise():
    for bad in [(0.0, 0.25), (0.3, 0.2), (0.1, 1.5)]:
        with pytest.raises(ValueError, match="delta"):
            BoxEnvironment(delta_min=bad[0], delta_max=bad[1])


# -- the reward ---------------------------------------------------------------

def test_reward_params_and_log_reward_match_jax():
    jenv, jp, tenv, tp = _pair()
    for k, v in tp.reward_params.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), _np(jp[k]), **REWARD)
    rng = np.random.RandomState(2)
    pos = rng.uniform(0, 1, (512, 2)).astype(np.float32)
    pos[:3] = [[0.32, 0.4], [0.6, 0.55], [0.82, 0.78]]     # the modes
    np.testing.assert_allclose(
        mixture_log_density(torch.from_numpy(pos), tp.reward_params).numpy(),
        _np(jax_mld(jnp.asarray(pos), jp)), **REWARD)
    js, ts = _state_pair(pos, np.full(512, 3, np.int32), np.ones(512, bool))
    np.testing.assert_allclose(tenv.log_reward(ts, tp).numpy(),
                               _np(jenv.log_reward(js, jp)), **REWARD)


# -- densities ----------------------------------------------------------------

def _mixture_inputs(n, seed, k=K):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, k).astype(np.float32)
    means = (2.0 * rng.randn(n, k)).astype(np.float32)
    log_scales = (1.2 * rng.randn(n, k)).astype(np.float32)
    lo = rng.uniform(0.0, 0.2, n).astype(np.float32)
    hi = (lo + rng.choice([1e-4, 0.05, 0.15, 0.5], n)).astype(np.float32)
    x = (lo + (hi - lo) * rng.uniform(-0.05, 1.05, n)).astype(np.float32)
    return logits, means, log_scales, x, lo, hi


def test_squashed_mixture_log_prob_matches_jax():
    """Widths down to below the 1e-3 floor, points on and past the
    support's ends (the u clip), means and scales past their clips."""
    args = _mixture_inputs(2048, 3)
    np.testing.assert_allclose(
        tflows.squashed_mixture_log_prob(*map(torch.from_numpy,
                                              args)).numpy(),
        _np(jflows.squashed_mixture_log_prob(*map(jnp.asarray, args))),
        **DENS)


def test_squashed_mixture_sample_matches_jax_draws():
    """The categorical is ``argmax(logits + gumbel(kc, logits.shape))``
    under JAX 0.9 (checked here on the batch), so the component, the
    normal and the squash equal JAX's sample over its own draws."""
    logits, means, log_scales, _, lo, hi = _mixture_inputs(1024, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 1024)
    kc, kn = jax.vmap(jax.random.split, out_axes=1)(keys)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(kc)
    comp = jax.vmap(lambda k, lg: jax.random.categorical(k, lg))(
        kc, jnp.asarray(logits))
    np.testing.assert_array_equal(
        _np(comp), np.argmax(logits + _np(gumbel), -1))
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))(kn)
    want = jax.vmap(jflows.squashed_mixture_sample)(
        keys, *map(jnp.asarray, (logits, means, log_scales, lo, hi)))
    got = tflows.squashed_mixture_sample(
        _t(gumbel), _t(normal), *map(torch.from_numpy,
                                     (logits, means, log_scales, lo, hi)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    assert bool(((got >= torch.from_numpy(lo))
                 & (got <= torch.from_numpy(lo) + torch.clamp(
                     torch.from_numpy(hi - lo), min=1e-3))).all())


@pytest.mark.parametrize("logit", [-30.0, -2.0, 0.0, 3.5, 40.0])
def test_exit_logprobs_match_jax(logit):
    can_inc = np.array([True, True, False, False])
    can_exit = np.array([True, False, True, False])
    x = np.full(4, logit, np.float32)
    got = tflows._exit_logprobs(torch.from_numpy(x),
                                torch.from_numpy(can_inc),
                                torch.from_numpy(can_exit))
    want = jflows._exit_logprobs(jnp.asarray(x), jnp.asarray(can_inc),
                                 jnp.asarray(can_exit))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), **DENS)
    assert float(got[0][2]) == 0.0 and float(got[1][2]) == -1e9  # forced
    assert float(got[0][1]) == -1e9 and float(got[1][1]) == 0.0  # no exit


@pytest.fixture(scope="module")
def policies():
    """A JAX flow policy and its port with the JAX parameters carried
    across (``params_from_jax``: ``torso/layer_i/{w,b}``, ``log_z``)."""
    jenv, jp, tenv, tp = _pair()
    jpol = jflows.make_box_flow_policy(jenv, hidden=HIDDEN, num_components=K,
                                       init_log_z=0.5)
    jparams = jpol.init(jax.random.PRNGKey(1))
    tpol = tflows.BoxFlowPolicy(tenv, hidden=HIDDEN, num_components=K,
                                device=CPU)
    flat = params_from_jax(jax.device_get(jparams))
    assert set(flat) == set(tpol.params.flat())
    tpol.load_params(flat)
    assert float(tpol.params["log_z"]) == 0.5
    return dict(jenv=jenv, jp=jp, tenv=tenv, tp=tp, jpol=jpol,
                jparams=jparams, tpol=tpol)


def _density_states(pp, n=512, seed=6):
    """Observations of seeded states and seeded actions: increments inside
    and past the supports, exits, terminal copies and one-step states."""
    tenv = pp["tenv"]
    pos, steps, terminal = _states(tenv, n, seed)
    js, ts = _state_pair(pos, steps, terminal)
    rng = np.random.RandomState(seed + 1)
    act = np.concatenate([rng.uniform(-0.05, 0.3, (n, 2)),
                          (rng.rand(n) < 0.3)[:, None]], 1).astype(np.float32)
    return (_np(pp["jenv"].observe(js, pp["jp"])),
            tenv.observe(ts, pp["tp"]), act)


def test_policy_density_entries_match_jax(policies):
    pp = policies
    jobs, tobs, act = _density_states(pp)
    np.testing.assert_array_equal(tobs.numpy(), jobs)
    jpol, jparams, tpol = pp["jpol"], pp["jparams"], pp["tpol"]
    ta = torch.from_numpy(act)
    want = jax.jit(lambda p, o, a: (jpol.log_prob(p, o, a),
                                    jpol.log_prob_b(p, o, a),
                                    jpol.log_state_flow(p, o)))(
        jparams, jnp.asarray(jobs), jnp.asarray(act))
    for name, got, want in zip(
            ("log_prob", "log_prob_b", "log_state_flow"),
            (tpol.log_prob(tobs, ta), tpol.log_prob_b(tobs, ta),
             tpol.log_state_flow(tobs)), want):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   err_msg=name, **DENS)
    # the torso's output, when given, is the one the entry computes itself
    out = tpol.torso(tobs)
    assert torch.equal(tpol.log_prob(tobs, ta, out), tpol.log_prob(tobs, ta))


def test_policy_density_gradients_match_jax(policies):
    """d/dparams of the summed forward and backward log-densities."""
    pp = policies
    jobs, tobs, act = _density_states(pp, n=128, seed=9)
    jpol, tpol = pp["jpol"], pp["tpol"]
    ta = torch.from_numpy(act)

    def jtotal(p):
        return (jnp.sum(jnp.where(jnp.asarray(act[:, 2]) > 0.5, 0.0,
                                  jpol.log_prob(p, jnp.asarray(jobs),
                                                jnp.asarray(act))))
                + jnp.sum(jpol.log_prob_b(p, jnp.asarray(jobs),
                                          jnp.asarray(act)))
                + jnp.sum(jpol.log_state_flow(p, jnp.asarray(jobs))))

    jgrads = params_from_jax(jax.device_get(
        jax.jit(jax.grad(jtotal))(pp["jparams"])))
    params = dict(tpol.params.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    total = (torch.where(ta[:, 2] > 0.5, 0.0, tpol.log_prob(tobs, ta)).sum()
             + tpol.log_prob_b(tobs, ta).sum()
             + tpol.log_state_flow(tobs).sum())
    total.backward()
    for name, p in tpol.params.flat().items():
        g = jgrads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        np.testing.assert_allclose(got, g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1.0),
                                   err_msg=name)
    for p in params.values():
        p.grad = None
        p.requires_grad_(False)


# -- sampling over JAX's draws ------------------------------------------------

@jax.jit
def _forward_draws(keys):
    def one(k):
        ke, km, kp, ku = jax.random.split(k, 4)
        kc, kn = jax.random.split(km)
        return (jax.random.gumbel(kc, (2, K)), jax.random.normal(kn, (2,)),
                jax.random.uniform(ke, ()), jax.random.uniform(kp, (2,)),
                jax.random.uniform(ku, (2,)))
    return jax.vmap(one)(keys)


def _jax_forward_draws(keys):
    """(B,) env keys -> FlowNoise of JAX's forward split."""
    return FlowNoise(*map(_t, _forward_draws(keys)))


def _sample_case(pp, n=256, seed=11):
    """Reachable observations (a JAX rollout's states) and the rollout's
    safe masks."""
    from repro.core.rollout import forward_rollout as jfr
    jb = jax.jit(lambda p: jfr(
        jax.random.PRNGKey(seed), pp["jenv"], pp["jp"], pp["jpol"], p,
        n // pp["jenv"].max_steps + 1, exploration_eps=jnp.float32(0.5)))(
        pp["jparams"])
    obs = _np(jb.obs[:-1]).reshape(-1, 4)[:n]
    mask = (_np(jb.fwd_mask[:-1]) | _np(jb.done[:-1])[..., None]).reshape(
        -1, 2)[:n]
    return obs, mask


def _hold_draws(pp, obs, ta, tlp, ja, jlp, backward=False):
    """Exit flags equal, increments within 1e-6.  The returned log-density
    is the policy's at the realised action; at JAX's action it is JAX's
    within 1e-5.  An increment an ulp from JAX's (``torch.sigmoid``
    against XLA's) moves the density by up to |d log p / dx| ulp, which is
    large where the squash is steep (``exp`` and ``sigmoid`` leave about a
    quarter of the increments an ulp off at this width): the
    log-densities of the port's own draws are held to JAX's within 1e-5
    where the actions are bitwise equal, at least half of the rows."""
    tpol = pp["tpol"]
    tobs = torch.from_numpy(obs)
    entry = tpol.log_prob_b if backward else tpol.log_prob
    np.testing.assert_array_equal(ta[:, 2].numpy(), ja[:, 2])
    np.testing.assert_allclose(ta[:, :2].numpy(), ja[:, :2], rtol=0,
                               atol=1e-6)
    assert torch.equal(tlp, entry(tobs, ta))
    np.testing.assert_allclose(entry(tobs, torch.from_numpy(ja)).numpy(),
                               _np(jlp), **DENS)
    same = (ta.numpy() == ja).all(1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(tlp.numpy()[same], _np(jlp)[same], **DENS)


@pytest.mark.parametrize("eps", [None, 0.1, 0.6])
def test_sample_over_jax_draws_matches_jax(policies, eps):
    pp = policies
    obs, mask = _sample_case(pp)
    keys = jax.random.split(jax.random.PRNGKey(12), obs.shape[0])
    jeps = 0.0 if eps is None else jnp.float32(eps)
    ja, jlp = jax.jit(lambda p, e: pp["jpol"].sample(
        p, jnp.asarray(obs), jnp.asarray(mask), keys, e))(pp["jparams"], jeps)
    teps = None if eps is None else torch.tensor(eps, dtype=torch.float32)
    ta, tlp = pp["tpol"].sample(torch.from_numpy(obs),
                                torch.from_numpy(mask),
                                _jax_forward_draws(keys), eps=teps)
    ja = _np(ja)
    assert ta.dtype == torch.float32 and ta.shape == (obs.shape[0], 3)
    _hold_draws(pp, obs, ta, tlp, ja, jlp)
    exits = ja[:, 2] > 0.5
    assert 0 < exits.sum() < exits.size
    if eps is not None:
        # both branches ran: some rows explored
        u = _np(jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k, 4)[2], (2,)))(keys))[:, 0]
        assert 0 < (u < eps).sum() < u.size


def test_sample_b_over_jax_draws_matches_jax(policies):
    pp = policies
    obs, mask = _sample_case(pp, seed=13)
    keys = jax.random.split(jax.random.PRNGKey(14), obs.shape[0])
    ja, jlp = jax.jit(lambda p: pp["jpol"].sample_b(
        p, jnp.asarray(obs), jnp.asarray(mask), keys))(pp["jparams"])
    kc, kn = jax.vmap(jax.random.split, out_axes=1)(keys)
    noise = FlowNoise(_t(jax.vmap(lambda k: jax.random.gumbel(k, (2, K)))(kc)),
                      _t(jax.vmap(lambda k: jax.random.normal(k, (2,)))(kn)))
    ta, tlp = pp["tpol"].sample_b(torch.from_numpy(obs),
                                  torch.from_numpy(mask), noise)
    _hold_draws(pp, obs, ta, tlp, _np(ja), jlp, backward=True)


# -- the flow hash noise ------------------------------------------------------

@pytest.mark.parametrize("source,forward", [(hash_flow_noise, True),
                                            (hash_flow_backward_noise, False)])
def test_flow_hash_noise_is_finite_and_row_independent(source, forward):
    n = 1 << 16
    seed = torch.full((n,), -(2 ** 62) + 12345, dtype=torch.int64)
    idx = torch.arange(n, dtype=torch.int64)
    t = torch.randint(0, 12, (n,), generator=torch.Generator().manual_seed(0))
    fn = source(seed, idx, t, (2, 4))
    assert fn.gumbel.shape == (n, 2, 4) and fn.normal.shape == (n, 2)
    assert torch.isfinite(fn.gumbel).all() and torch.isfinite(fn.normal).all()
    assert abs(float(fn.normal.mean())) < 0.02
    assert abs(float(fn.normal.std()) - 1.0) < 0.02
    uniforms = ([fn.exit_u, fn.explore_u, fn.unif] if forward else [])
    if not forward:
        assert fn.exit_u is None and fn.explore_u is None and fn.unif is None
    for u in uniforms:
        assert bool(((u > 0) & (u < 1)).all())
        assert abs(float(u.mean()) - 0.5) < 0.01
    # a row's noise is a function of its own (seed, index, t)
    sub = source(seed[7:9], idx[7:9], t[7:9], (2, 4))
    for a, b in zip(sub, fn):
        if a is not None:
            assert torch.equal(a, b[7:9])


def test_flow_noise_streams_differ_from_each_other_and_by_step():
    seed = torch.zeros(64, dtype=torch.int64)
    idx = torch.arange(64)
    f0 = hash_flow_noise(seed, idx, torch.zeros_like(idx), (2, 4))
    f1 = hash_flow_noise(seed, idx, torch.ones_like(idx), (2, 4))
    b0 = hash_flow_backward_noise(seed, idx, torch.zeros_like(idx), (2, 4))
    assert not torch.equal(f0.gumbel, f1.gumbel)
    assert not torch.equal(f0.gumbel, b0.gumbel)
    assert not torch.equal(f0.normal, b0.normal)


# -- a fault of the reference's geometry (ROADMAP queue 3) --------------------

def test_increment_arm_is_legal_over_an_empty_support_near_the_edge():
    """Within ``_BOUNDARY_TOL`` above 1 - delta_min the increment arm is
    legal while ``forward_support`` is empty (hi < lo), against the
    reference's docstring ("empty exactly when the increment arm is
    off"); an increment of delta_min there overshoots 1, the clip pins the
    coordinate at 1, and the backward step removing the same increment
    does not return to the source state.  The port keeps the reference's
    geometry, bitwise."""
    jenv, jp, tenv, tp = _pair()
    x = np.float32(0.9000005)
    js, ts = _state_pair(np.array([[x, 0.5]], np.float32),
                         np.array([4], np.int32), np.array([False]))
    act = np.array([[tenv.delta_min, 0.1, 0.0]], np.float32)
    for env, s, p, arr in ((jenv, js, jp, jnp.asarray),
                           (tenv, ts, tp, torch.from_numpy)):
        lo, hi = env.forward_support(s.pos)
        assert bool(env.forward_mask(s, p)[0, 0])       # increment legal
        assert float(hi[0, 0]) < float(lo[0, 0])        # over no support
        nxt = env.step(s, arr(act), p)[1]
        assert float(nxt.pos[0, 0]) == 1.0
        back = env.backward_step(nxt, arr(act), p)[1]
        assert float(back.pos[0, 0]) != float(x)
        assert float(back.pos[0, 1]) == 0.5
