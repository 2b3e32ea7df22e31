"""The port's continuous Box training path against the JAX package's:
``forward_rollout``'s continuous branch (64 envs, the recipe's width,
epsilon 0.1 and the non-exploring eval rollout) and the collecting
``backward_rollout`` field by field over JAX's draws replayed; TB and DB
parts and their gradients through the density path; the quadrature
eval's target and binning; three ``TrainLoop`` iterations of ``box_tb``
and ``box_db`` at a small width; the recipe end to end on the CPU.

Noise: a flow-noise source replaying JAX's draws (env e at step t folds
``split(key, T)[t]`` with e; forward ``split(k, 4)`` = ``(k_exit, k_mix,
k_eps, k_unif)``, ``split(k_mix)`` = ``(kc, kn)``; backward ``split(k)`` =
``(kc, kn)``).  Iteration i of ``repro.algo.TrainLoop`` rolls out with
``k_sample_i``: ``key_0 = split(key)[1]``, ``key_{i+1}, k_sample_i =
split(key_i)``.

Tolerances (fp32 on both sides; ``exp``, ``sigmoid`` and ``logsigmoid``
round other than XLA's by an ulp, so increments, and positions summed from
them, may sit an ulp apart): masks, done, valid and exit flags bitwise;
observations, positions and actions within 1e-6; log R within 1e-5
(relative and absolute: its slope, up to ~40 per unit within a few sigma
of a mode, turns a position an ulp off into a few 1e-6); log-densities
within 1e-5 (relative and absolute) at JAX's actions, and at the port's
own where its action is bitwise JAX's (a density is steep in x near the
squash's ends, so an ulp there moves it more); losses 1e-5 relative;
gradients 1e-4 relative with a floor of 1e-6 of the tensor's largest
entry; parameters after Adam steps 1e-3 * lr per step, and 2 * lr per step
where |g| <= 1e-6 (Adam's first update there is lr * sign(g), which
rounding may flip).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.core.rollout import backward_rollout as jax_backward  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs.box import BoxEnvironment as JaxBox  # noqa: E402
from repro.envs.box import BoxState as JaxState  # noqa: E402
from repro.evals.quadrature import QuadratureDistributionEval as JaxQuad  # noqa: E402
from repro.nn.flows import make_box_flow_policy  # noqa: E402
from repro.rewards.box import BoxRewardModule as JaxReward  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.objectives import evaluate_trajectory  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.rollout import (RolloutBatch, backward_rollout,  # noqa: E402
                                      forward_rollout)
from repro_torch.core.trainer import GFNConfig, make_loss_parts_fn  # noqa: E402
from repro_torch.core.types import FlowNoise, hash_flow_noise  # noqa: E402
from repro_torch.envs.box import BoxEnvironment, BoxState  # noqa: E402
from repro_torch.evals import QuadratureDistributionEval  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn.flows import BoxFlowPolicy  # noqa: E402
from repro_torch.recipes import box as box_recipe  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 64
DENS = dict(rtol=1e-5, atol=1e-5)
LR, LOG_Z_LR, EPS = 1e-3, 1e-1, 0.1
ITERS = 3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
FIELDS_EXACT = ("fwd_mask", "bwd_mask", "valid", "done")
FIELDS_NEAR = ("obs", "actions", "bwd_actions")


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@jax.jit
def _flow_rows(key, ids, ts, shape):
    """JAX's forward draws (gumbel, normal, exit_u, explore_u, unif) of env
    ids[r] at step ts[r] of a rollout keyed ``key`` over T steps
    (``shape`` is (T, D, K))."""
    T, D, K = shape.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        ke, km, kp, ku = jax.random.split(
            jax.random.fold_in(step_keys[t], i), 4)
        kc, kn = jax.random.split(km)
        return (jax.random.gumbel(kc, (D, K)), jax.random.normal(kn, (D,)),
                jax.random.uniform(ke, ()), jax.random.uniform(kp, (2,)),
                jax.random.uniform(ku, (D,)))

    return jax.vmap(one)(ids, ts)


@jax.jit
def _flow_rows_b(key, ids, ts, shape):
    """JAX's backward draws (gumbel, normal)."""
    T, D, K = shape.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        kc, kn = jax.random.split(jax.random.fold_in(step_keys[t], i))
        return jax.random.gumbel(kc, (D, K)), jax.random.normal(kn, (D,))

    return jax.vmap(one)(ids, ts)


def replay_flow_noise(key_of, T, backward=False):
    """A flow-noise source replaying JAX's draws; ``key_of(seed)`` names
    the rollout key of the (64-bit) noise seed the port passes."""
    rows = _flow_rows_b if backward else _flow_rows

    def noise(seed, index, t, dims):
        out = rows(key_of(int(seed[0])), jnp.asarray(index.numpy(), jnp.int32),
                   jnp.asarray(t.numpy(), jnp.int32),
                   jnp.zeros((T,) + tuple(dims)))
        return FlowNoise(*map(_t, out))

    return noise


def _jax_batch_to_torch(jb) -> RolloutBatch:
    return RolloutBatch(**{f: _t(getattr(jb, f))
                           for f in RolloutBatch.__dataclass_fields__})


@pytest.fixture(scope="module")
def full():
    """The recipe's env and policy width (4 -> 128 -> 128 -> 50, K = 4),
    JAX-initialised parameters carried across."""
    jenv, tenv = JaxBox(JaxReward()), BoxEnvironment()
    jpol = make_box_flow_policy(jenv, hidden=(128, 128), num_components=4)
    jparams = jpol.init(jax.random.PRNGKey(1))
    tpol = box_recipe.box_policy(tenv, device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return dict(jenv=jenv, jp=jenv.init(jax.random.PRNGKey(0)), tenv=tenv,
                tp=tenv.init(CPU), jpol=jpol, jparams=jparams, tpol=tpol)


def assert_batch_near_jax(tb, jb, what=""):
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)),
                                      err_msg=f"{what} {f}")
    for f in FIELDS_NEAR:
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   _np(getattr(jb, f)), rtol=0, atol=1e-6,
                                   err_msg=f"{what} {f}")
    # exit flags and the step fraction exactly
    np.testing.assert_array_equal(tb.actions[..., 2].numpy(),
                                  _np(jb.actions)[..., 2], err_msg=what)
    np.testing.assert_array_equal(tb.obs[..., 2:].numpy(),
                                  _np(jb.obs)[..., 2:], err_msg=what)
    np.testing.assert_allclose(tb.log_reward.numpy(), _np(jb.log_reward),
                               err_msg=what, **DENS)
    assert tb.actions.dtype == torch.float32 and tb.obs.dtype == torch.float32


_ROLLOUTS = {}


def _rollouts(full, eps):
    """JAX's and the port's forward rollout of B envs over one key, at
    epsilon ``eps`` (None: the non-exploring eval rollout); made once."""
    if eps in _ROLLOUTS:
        return _ROLLOUTS[eps]
    key = jax.random.PRNGKey(7)
    jb = jax.jit(lambda p, e: jax_forward(
        key, full["jenv"], full["jp"], full["jpol"], p, B,
        exploration_eps=e))(full["jparams"],
                            0.0 if eps is None else jnp.float32(eps)) \
        if eps is not None else jax.jit(lambda p: jax_forward(
            key, full["jenv"], full["jp"], full["jpol"], p, B))(
            full["jparams"])
    tb = forward_rollout(
        0, full["tenv"], full["tp"], full["tpol"], B,
        noise=replay_flow_noise(lambda s: key, full["tenv"].max_steps),
        exploration_eps=None if eps is None else torch.tensor(
            eps, dtype=torch.float32))
    _ROLLOUTS[eps] = eps, jb, tb
    return _ROLLOUTS[eps]


@pytest.fixture(params=[0.1, None], ids=["eps0.1", "eval"])
def rollouts(request, full):
    return _rollouts(full, request.param)


def test_forward_rollout_matches_jax(full, rollouts):
    eps, jb, tb = rollouts
    assert_batch_near_jax(tb, jb, f"eps {eps}")
    np.testing.assert_array_equal(tb.log_r_state.numpy(), 0.0)
    np.testing.assert_array_equal(tb.energy.numpy(), 0.0)
    # every rollout exits, at different depths
    assert bool(tb.done[-1].all())
    depth = tb.valid.sum(0)
    assert int(depth.min()) < int(depth.max())
    # log P_F of the sampled actions: JAX's within 1e-5 where the step's
    # action is bitwise JAX's, and the port's density at JAX's actions
    # everywhere (the teacher-forced path on JAX's own batch)
    same = (tb.actions.numpy() == _np(jb.actions)).all(-1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(tb.log_pf_beh.numpy()[same],
                               _np(jb.log_pf_beh)[same], **DENS)
    with torch.no_grad():
        ev = evaluate_trajectory(full["tpol"], _jax_batch_to_torch(jb))
    np.testing.assert_allclose(ev.log_pf.numpy(), _np(jb.log_pf_beh), **DENS)


def test_collecting_backward_rollout_matches_jax(full):
    """From the exploring forward rollout's terminal states: every field
    of the forward-ordered batch, its dtypes and shapes those of the
    forward rollout's, and the log P_F / log P_B totals."""
    _, jb, tb = _rollouts(full, 0.1)
    pos = _np(jb.obs[-1])[:, :2]
    steps = np.round(_np(jb.obs[-1])[:, 2] * full["tenv"].max_steps).astype(
        np.int32)
    jterm = JaxState(pos=jnp.asarray(pos), terminal=jnp.ones(B, bool),
                     steps=jnp.asarray(steps))
    tterm = BoxState(pos=torch.from_numpy(pos),
                     terminal=torch.ones(B, dtype=torch.bool),
                     steps=torch.from_numpy(steps))
    key = jax.random.PRNGKey(11)
    jbr = jax.jit(lambda p: jax_backward(
        key, full["jenv"], full["jp"], full["jpol"], p, jterm,
        collect=True))(full["jparams"])
    tbr = backward_rollout(
        0, full["tenv"], full["tp"], full["tpol"], tterm,
        noise=replay_flow_noise(lambda s: key, full["tenv"].max_steps,
                                backward=True), collect=True)
    assert_batch_near_jax(tbr.batch, jbr.batch, "backward")
    for f in RolloutBatch.__dataclass_fields__:
        got = getattr(tbr.batch, f)
        assert got.dtype == getattr(tb, f).dtype, f
        assert got.shape == getattr(tb, f).shape, f
    # the trajectory reaches s0 and is left-padded; every row has a
    # Dirac step back to s0 (log P_B 0 there)
    assert bool((tbr.batch.obs[0] == 0).all())
    np.testing.assert_array_equal(tbr.batch.valid.sum(0).numpy(), steps)
    with torch.no_grad():
        ev = evaluate_trajectory(full["tpol"], _jax_batch_to_torch(jbr.batch))
    np.testing.assert_allclose(ev.log_pf.sum(0).numpy(), _np(jbr.log_pf),
                               **DENS)
    np.testing.assert_allclose(ev.log_pb.sum(0).numpy(), _np(jbr.log_pb),
                               **DENS)
    same = (tbr.batch.actions.numpy() == _np(jbr.batch.actions)).all((0, 2))
    assert same.mean() > 0.25
    np.testing.assert_allclose(tbr.log_pf.numpy()[same],
                               _np(jbr.log_pf)[same], **DENS)
    np.testing.assert_allclose(tbr.log_pb.numpy()[same],
                               _np(jbr.log_pb)[same], **DENS)
    # collecting changes no arithmetic of the totals
    plain = backward_rollout(
        0, full["tenv"], full["tp"], full["tpol"], tterm,
        noise=replay_flow_noise(lambda s: key, full["tenv"].max_steps,
                                backward=True))
    assert torch.equal(plain.log_pf, tbr.log_pf)
    assert torch.equal(plain.log_pb, tbr.log_pb)


def test_uniform_backward_policy_and_a_categorical_policy_raise(full):
    _, term = full["tenv"].reset(4, full["tp"])
    with pytest.raises(ValueError, match="undefined over continuous"):
        backward_rollout(0, full["tenv"], full["tp"], full["tpol"], term,
                         backward_policy="uniform")
    mlp = MLPPolicy(4, 2, hidden=(8,), device=CPU)
    with pytest.raises(ValueError, match="density entry points"):
        forward_rollout(0, full["tenv"], full["tp"], mlp, 4)


def test_hash_flow_noise_is_the_default_of_rollout_and_sampler(full):
    a = forward_rollout(3, full["tenv"], full["tp"], full["tpol"], 8,
                        exploration_eps=0.1)
    b = forward_rollout(3, full["tenv"], full["tp"], full["tpol"], 8,
                        noise=hash_flow_noise, exploration_eps=0.1)
    for f in RolloutBatch.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    cfg = GFNConfig(num_envs=8, exploration_eps=0.1)
    init, sample = OnPolicySampler().build(full["tenv"], full["tp"],
                                           full["tpol"], cfg)
    _, c = sample(init(), torch.tensor(3), torch.tensor(0))
    assert torch.equal(a.actions, c.actions)


# -- objectives ---------------------------------------------------------------

@pytest.mark.parametrize("objective", ["tb", "db"])
def test_parts_and_gradients_match_jax(full, rollouts, objective,
                                       monkeypatch):
    """TB and DB parts on JAX's batch through the density path, and their
    gradients; the path calls no kernel wrapper (float actions never reach
    ``traj_logprob``)."""
    eps, jb, _ = rollouts
    kw = dict(objective=objective, num_envs=B, stop_action=None)
    jfn = jax_parts_fn(full["jenv"], full["jpol"], JaxGFNConfig(**kw))
    (jnum, jden), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        full["jparams"], jb)
    jgrads = params_from_jax(jax.device_get(jgrads))

    def refuse(*a, **k):
        raise AssertionError("traj_logprob on the density path")

    monkeypatch.setattr(ops, "traj_logprob", refuse)
    import repro_torch.core.objectives as objectives
    monkeypatch.setattr(objectives, "traj_logprob", refuse)
    tpol = full["tpol"]
    for p in tpol.params.parameters():
        p.requires_grad_(True)
        p.grad = None
    try:
        num, den = make_loss_parts_fn(full["tenv"], tpol, GFNConfig(**kw))(
            _jax_batch_to_torch(jb))
        num.backward()
        np.testing.assert_allclose(float(num.detach()), float(jnum),
                                   rtol=1e-5)
        assert float(den) == float(jden)
        assert torch.isfinite(num)
        for name, p in tpol.params.flat().items():
            g = jgrads[name].numpy()
            got = (p.grad if p.grad is not None
                   else torch.zeros_like(p)).numpy()
            assert np.isfinite(got).all(), name
            np.testing.assert_allclose(got, g, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * np.abs(g).max(),
                                       err_msg=f"{objective} {name} {eps}")
    finally:
        for p in tpol.params.parameters():
            p.grad = None
            p.requires_grad_(False)


# -- the quadrature eval ------------------------------------------------------

def test_quadrature_target_and_binning_match_jax(full):
    jev = JaxQuad(full["jenv"], full["jp"], full["jpol"], grid_size=16,
                  num_samples=64)
    tev = QuadratureDistributionEval(full["tenv"], full["tp"], full["tpol"],
                                     grid_size=16, num_samples=64)
    np.testing.assert_allclose(tev.target.numpy(), _np(jev.target),
                               rtol=1e-5, atol=1e-9)
    assert abs(float(tev.target.sum()) - 1.0) < 1e-5
    rng = np.random.RandomState(3)
    pos = rng.uniform(0, 1, (512, 2)).astype(np.float32)
    pos[:34] = np.stack(np.meshgrid(np.arange(17) / 16, [0.0, 1.0]),
                        -1).reshape(-1, 2)        # cell edges, 0 and 1
    pos[34:40] = np.float32(np.nextafter(np.float32(1 / 16), 0))
    got = tev.flat_index(torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jev.flat_index(jnp.asarray(pos))))
    out = tev(0)
    assert set(out) == {"quad_tv", "quad_jsd"}
    assert 0 < float(out["quad_tv"]) <= 1 and float(out["quad_jsd"]) > 0
    # a non-exploring rollout: the eval draws the same terminals again
    assert torch.equal(tev(0)["quad_tv"], out["quad_tv"])


# -- three TrainLoop iterations against the JAX package's ---------------------

SMALL = dict(hidden=(16, 16), num_components=2)


def _three_iterations(objective):
    jenv, tenv = JaxBox(JaxReward()), BoxEnvironment()
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    jpol = make_box_flow_policy(jenv, **SMALL)
    key = jax.random.PRNGKey(3)
    kw = dict(objective=objective, num_envs=16, lr=LR, log_z_lr=LOG_Z_LR,
              stop_action=None, exploration_eps=EPS)
    jrows = []

    def cb(it, ts, metrics, batch):
        jrows.append({"params": jax.tree_util.tree_map(_np, ts.params),
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "batch": jax.tree_util.tree_map(_np, batch)})

    JaxTrainLoop(jenv, jp, jpol, JaxGFNConfig(**kw)).run(
        key, ITERS, mode="python", callback=cb, callback_every=1)
    jparams0 = jpol.init(jax.random.split(key)[0])
    (_, jden), jgrads = jax.jit(jax.value_and_grad(
        jax_parts_fn(jenv, jpol, JaxGFNConfig(**kw)), has_aux=True))(
        jparams0, jax.tree_util.tree_map(jnp.asarray, jrows[0]["batch"]))
    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda g: _np(g / jnp.maximum(jden, 1.0)), jgrads))
    k_samples, k = [], jax.random.split(key)[1]
    for _ in range(ITERS):
        k, ks = jax.random.split(k)
        k_samples.append(ks)
    tpol = BoxFlowPolicy(tenv, device=CPU, requires_grad=True, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams0)))
    loop = TrainLoop(tenv, tp, tpol, GFNConfig(**kw), sampler=OnPolicySampler(
        noise=replay_flow_noise(lambda s: k_samples[s & 0xFFFFFFFF],
                                tenv.max_steps)))
    state = loop.init(seed=0)
    trows = []
    for _ in range(ITERS):
        metrics, batch = loop.iteration(state)
        trows.append({"batch": batch, "loss": float(metrics["loss"]),
                      "grads": {n: p.grad.clone() for n, p in
                                tpol.params.flat().items()},
                      "params": {n: p.detach().clone() for n, p in
                                 tpol.params.flat().items()},
                      "log_z": float(metrics["log_z"])})
    return jrows, trows, jgrads


@pytest.fixture(scope="module", params=["tb", "db"])
def three_iterations(request):
    return request.param, _three_iterations(request.param)


def test_iterations_match_jax(three_iterations):
    objective, (jrows, trows, jgrads) = three_iterations
    for it, (jr, tr) in enumerate(zip(jrows, trows)):
        assert_batch_near_jax(tr["batch"], jr["batch"],
                              f"{objective} it {it}")
        np.testing.assert_allclose(tr["loss"], jr["metrics"]["loss"],
                                   rtol=1e-5, err_msg=f"{objective} it {it}")
        np.testing.assert_allclose(tr["log_z"], jr["metrics"]["log_z"],
                                   rtol=1e-5, atol=1e-7)
        assert np.isfinite(tr["loss"])
    for name, g in jgrads.items():
        g = g.numpy()
        np.testing.assert_allclose(trows[0]["grads"][name].numpy(), g,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max(),
                                   err_msg=f"{objective} {name}")
    for it, (jr, tr) in enumerate(zip(jrows, trows)):
        jflat = params_from_jax(jr["params"])
        for name, p in tr["params"].items():
            lr = LOG_Z_LR if name == "log_z" else LR
            want, got = jflat[name].numpy(), p.numpy()
            big = np.abs(jgrads[name].numpy()) > 1e-6
            np.testing.assert_allclose(got[big], want[big], rtol=0,
                                       atol=1e-3 * lr * (it + 1),
                                       err_msg=f"{objective} {name} it {it}")
            assert np.all(np.abs(got - want)[~big]
                          <= 2 * lr * (it + 1) + 1e-7), (name, it)


# -- the recipe and the CLI ---------------------------------------------------

def test_recipes_match_jax_registration():
    import repro.recipes  # noqa: F401
    from repro.recipes.base import RunOptions, get
    from repro_torch import recipes
    for obj in ("tb", "db"):
        jr, tr = get(f"box_{obj}"), recipes.get_train(f"box_{obj}")
        assert (tr.iterations, tr.num_envs, tr.eval_every) == (
            jr.iterations, jr.num_envs, jr.eval_every) == (30000, 64, 1500)
        env = tr.make_env()
        jcfg = jr.make_config(jr.make_env(), RunOptions(num_envs=64))
        assert tuple(tr.make_config(env, 64, 30000)) == tuple(jcfg)
        ev, = tr.make_evals(env, env.init(CPU), tr.make_policy(env,
                                                               device=CPU),
                            eval_batch=64)
        assert (ev.grid_size, ev.num_samples) == (16, 8192)


def test_run_recipe_box_tb_on_the_cpu():
    """As ``tests/test_box.py::test_box_short_training_smoke``: finite
    losses, eval rows with the quadrature metrics."""
    out = torch_run.run_recipe("box_tb", iterations=8, num_envs=16,
                               eval_every=4, eval_batch=64, device="cpu",
                               log=lambda *_: None)
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert [r["step"] for r in out["rows"]] == [0, 4]
    for row in out["rows"]:
        assert {"quad_tv", "quad_jsd"} <= set(row)
        assert np.isfinite(row["quad_tv"]) and np.isfinite(row["quad_jsd"])


def test_cli_trains_box_db_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "box_db", "--iterations", "2",
                           "--device", "cpu", "--eval-every", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln.split() for ln in out if ln.startswith("it ")]
    assert len(rows) == 2 and all(np.isfinite(float(r[3])) for r in rows)
    assert "on cpu" in out[-1]


def test_cli_refuses_to_run_box_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "box_tb", "--iterations", "1"])
