"""The port's hypergrid training against the JAX package's: the config's
fields, the objective identities at the optimum, three iterations of
``TrainLoop`` for TB, DB and SubTB on a 2x5 grid with an MLP (16, 16)
whose JAX-initialised parameters are carried across, and the CLI.

Noise: a step-noise source that replays JAX's draws, as
``tests/test_torch_train.py`` does.  Iteration i of ``repro.algo.TrainLoop``
samples with ``k_sample = split(key_i)[1]``; env e at step t folds
``split(k_sample, T)[t]`` with e and splits the result into
``(key_u, key_c, key_m)``.

Tolerances (fp32 on both sides, other reduction orders): actions bitwise;
losses 1e-5 relative; step-1 gradients 1e-4 relative with a floor of 1e-6
of the tensor's largest entry; parameters after Adam steps 1e-3 * lr per
step, and 2 * lr per step where |g| <= 1e-6 (there Adam's first update is
lr * sign(g), and the two packages' gradients may round to either sign).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.objectives import (OBJECTIVE_PARTS,  # noqa: E402
                                         evaluate_trajectory)
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIM, SIDE = 2, 5
HIDDEN = (16, 16)
B = 4
EPS = 0.5            # explore on about half the rows: both branches run
ANNEAL = 4
LR, LOG_Z_LR = 1e-3, 1e-1
ITERS = 3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _np(x):
    return np.array(x)


def test_gfnconfig_matches_jax():
    from repro.core.trainer import GFNConfig as Jax
    assert GFNConfig._fields == Jax._fields
    assert GFNConfig._field_defaults == Jax._field_defaults
    # a config built positionally means the same in both packages
    args = ("subtb", 8, 2e-3, 0.2, 0.0, None, 0.7, 0.1, 5, 2)
    assert GFNConfig(*args)._asdict() == Jax(*args)._asdict()


# -- the identities: every loss vanishes at the optimum -------------------------

class _TablePolicy:
    """A policy read from tables over the grid: P_F and log F exact by
    backward induction under the uniform P_B (port of the construction of
    ``tests/test_objectives.py::TestIdentities``)."""

    def __init__(self, env, log_r):
        side, dim = env.side, env.dim
        states = list(itertools.product(range(side), repeat=dim))
        idx = {s: i for i, s in enumerate(states)}
        flow = np.zeros(len(states))
        for s in sorted(states, key=lambda s: -sum(s)):
            f = np.exp(log_r[idx[s]])
            for i in range(dim):
                c = tuple(v + (j == i) for j, v in enumerate(s))
                if c in idx:
                    f += flow[idx[c]] / sum(1 for v in c if v > 0)
            flow[idx[s]] = f
        logits = np.full((len(states), dim + 1), -np.inf)
        for s in states:
            logits[idx[s], dim] = log_r[idx[s]]
            for i in range(dim):
                c = tuple(v + (j == i) for j, v in enumerate(s))
                if c in idx:
                    logits[idx[s], i] = np.log(
                        flow[idx[c]] / sum(1 for v in c if v > 0))
        self.env = env
        self.logits = torch.tensor(logits, dtype=torch.float32)
        self.log_flow = torch.tensor(np.log(flow), dtype=torch.float32)
        self.params = {"log_z": torch.tensor(
            float(np.log(np.exp(log_r).sum())), dtype=torch.float32)}

    def apply(self, obs):
        pos = obs.reshape(-1, self.env.dim, self.env.side).argmax(-1)
        flat = self.env.flatten_index(pos)
        return {"logits": self.logits[flat],
                "logits_b": torch.zeros(obs.shape[0],
                                        self.env.backward_action_dim),
                "log_flow": self.log_flow[flat]}


def test_losses_zero_at_optimum():
    """2x3 grid, perfect flows: TB, DB and SubTB under 1e-6 through the
    port's ``evaluate_trajectory`` with the stop action."""
    env = HypergridEnvironment(dim=2, side=3)
    params = env.init(CPU)
    policy = _TablePolicy(env, env.true_log_rewards(params).numpy()
                          .astype(np.float64))
    batch = forward_rollout(0, env, params, policy, 64)
    assert batch.done[-1].all()
    ev = evaluate_trajectory(policy, batch, stop_action=env.dim)
    cfg = GFNConfig(subtb_lambda=0.9)
    for name in ("tb", "db", "subtb"):
        num, den = OBJECTIVE_PARTS[name](ev, batch, policy.params, cfg)
        assert float(num / torch.clamp(den, min=1.0)) < 1e-6, name


# -- three TrainLoop iterations against the JAX package's ----------------------

@jax.jit
def _replay_rows(k_sample, ids, ts, shape_ta):
    """JAX's (gumbel_c, gumbel_u, u_m) for env ids[r] at step ts[r] of a
    rollout keyed ``k_sample`` over T = shape_ta.shape[0] steps and A =
    shape_ta.shape[1] actions."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(k_sample, T)

    def one(i, t):
        env_key = jax.random.fold_in(step_keys[t], i)
        key_u, key_c, key_m = jax.random.split(env_key, 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def replay_step_noise(k_sample_of, T):
    """A step-noise source replaying JAX's draws; ``k_sample_of(seed)``
    names the rollout key of the 64-bit noise seed the port passes."""

    def noise(seed, index, t, num_actions):
        g, gu, u = _replay_rows(k_sample_of(int(seed[0])),
                                jnp.asarray(index.numpy(), jnp.int32),
                                jnp.asarray(t.numpy(), jnp.int32),
                                jnp.zeros((T, num_actions)))
        return StepNoise(torch.from_numpy(_np(g)), torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))

    return noise


@pytest.fixture(scope="module")
def pair():
    jenv = JaxHypergrid(JaxReward(), dim=DIM, side=SIDE)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=HIDDEN)
    key = jax.random.PRNGKey(3)
    tenv = HypergridEnvironment(HypergridRewardModule(), dim=DIM, side=SIDE)
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, key), \
        (tenv, tenv.init(CPU))


def _torch_policy(jparams, tenv):
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=HIDDEN, device=CPU, requires_grad=True)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return tpol


def _cfgs(objective):
    kw = dict(objective=objective, num_envs=B, lr=LR, log_z_lr=LOG_Z_LR,
              stop_action=DIM, exploration_eps=EPS,
              exploration_anneal_steps=ANNEAL)
    return JaxGFNConfig(**kw), GFNConfig(**kw)


def _three_iterations(pair, objective):
    (jenv, jp, jpol, key), (tenv, tp) = pair
    jcfg, cfg = _cfgs(objective)
    jrows = []

    def cb(it, ts, metrics, batch):
        jrows.append({"params": jax.tree_util.tree_map(_np, ts.params),
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "batch": jax.tree_util.tree_map(_np, batch)})

    JaxTrainLoop(jenv, jp, jpol, jcfg).run(key, ITERS, mode="python",
                                          callback=cb, callback_every=1)
    jparams0 = jpol.init(jax.random.split(key)[0])
    (jnum, jden), jgrads = jax.value_and_grad(
        jax_parts_fn(jenv, jpol, jcfg), has_aux=True)(
        jparams0, jax.tree_util.tree_map(jnp.asarray, jrows[0]["batch"]))
    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda g: _np(g / jnp.maximum(jden, 1.0)), jgrads))

    # the loop's key chain: key_0 = split(key)[1]; key_{i+1}, k_sample_i =
    # split(key_i)
    k_samples, k = [], jax.random.split(key)[1]
    for _ in range(ITERS):
        k, ks = jax.random.split(k)
        k_samples.append(ks)
    tpol = _torch_policy(jparams0, tenv)
    loop = TrainLoop(tenv, tp, tpol, cfg, sampler=OnPolicySampler(
        noise=replay_step_noise(lambda s: k_samples[s & 0xFFFFFFFF],
                                tenv.max_steps)))
    state = loop.init(seed=0)
    trows = []
    for _ in range(ITERS):
        batch = loop.sample(state)
        loss = loop.loss_and_grads(batch)
        grads = {n: p.grad.clone() for n, p in tpol.params.flat().items()}
        state.optimizer.step()
        state.step += 1
        trows.append({"batch": batch, "loss": float(loss), "grads": grads,
                      "params": {n: p.detach().clone() for n, p in
                                 tpol.params.flat().items()},
                      "log_z": float(tpol.params["log_z"].detach())})
    return jrows, trows, jgrads, k_samples


@pytest.fixture(scope="module", params=["tb", "db", "subtb"])
def three_iterations(request, pair):
    return request.param, _three_iterations(pair, request.param)


def test_batches_and_losses_match_jax(three_iterations):
    objective, (jrows, trows, _, k_samples) = three_iterations
    for it, (jr, tr) in enumerate(zip(jrows, trows)):
        jb, tb = jr["batch"], tr["batch"]
        for name in ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
                     "valid", "done"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          getattr(jb, name),
                                          err_msg=f"{name} it {it}")
        np.testing.assert_allclose(tb.log_reward.numpy(), jb.log_reward,
                                   rtol=1e-6)
        np.testing.assert_allclose(tb.log_pf_beh.numpy(), jb.log_pf_beh,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tr["loss"], jr["metrics"]["loss"],
                                   rtol=1e-5, err_msg=f"{objective} it {it}")
        np.testing.assert_allclose(tr["log_z"], jr["metrics"]["log_z"],
                                   rtol=1e-5, atol=1e-7)
    # iteration 0 (epsilon 0.5) took both branches: some live steps
    # explored (u < epsilon) and some did not
    valid = trows[0]["batch"].valid.numpy()
    T = valid.shape[0]
    ids, ts = np.tile(np.arange(B), T), np.repeat(np.arange(T), B)
    _, _, u = _replay_rows(k_samples[0], jnp.asarray(ids), jnp.asarray(ts),
                           jnp.zeros((T, DIM + 1)))
    explored = _np(u).reshape(T, B)[valid] < EPS
    assert 0 < explored.sum() < explored.size


def test_step1_gradients_match_jax(three_iterations):
    objective, (_, trows, jgrads, _) = three_iterations
    tgrads = trows[0]["grads"]
    assert set(tgrads) == set(jgrads)
    for name, g in jgrads.items():
        g = g.numpy()
        np.testing.assert_allclose(tgrads[name].numpy(), g,
                                   err_msg=f"{objective} {name}",
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max())


def test_parameters_follow_the_adam_rule(three_iterations):
    objective, (jrows, trows, jgrads, _) = three_iterations
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


# -- the CLI ---------------------------------------------------------------------

def test_cli_trains_hypergrid_subtb_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "hypergrid_subtb", "--iterations", "3",
                           "--device", "cpu", "--set", "dim=2",
                           "--set", "side=4", "--eval-every", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("it ")]
    assert len(rows) == 3
    for ln in rows:
        vals = ln.split()
        assert vals[2] == "loss" and np.isfinite(float(vals[3]))
    evals = [ln.split() for ln in out if ln.startswith("eval it ")]
    assert [int(e[2]) for e in evals] == [0, 2]
    for e in evals:
        metrics = dict(zip(e[3::2], map(float, e[4::2])))
        assert set(metrics) == {"exact_tv", "exact_jsd", "sample_tv",
                                "sample_jsd", "mode_hits", "elbo",
                                "log_z_is", "eubo"}
        assert all(np.isfinite(v) for v in metrics.values())
        assert 0 <= metrics["exact_tv"] <= 1
    assert "on cpu" in out[-1]


def test_cli_refuses_to_run_hypergrid_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "hypergrid_subtb", "--iterations", "1"])
