"""The port's Bayesian-network structure learning against the JAX
package's: the dataset and both score tables (bitwise), the DAG
enumeration and exact posterior, the environment's forward and backward
steps with their masks and closure, MDB's parts on a JAX batch, one
``dag_mdb`` iteration at d = 3 with JAX's parameters carried across and its
noise replayed, the device JSD against the JAX recipe's host JSD on the
same samples, and the CLI.

Noise: a step-noise source that replays JAX's draws (env e at step t folds
``split(k_sample, T)[t]`` with e and splits the result into
``(key_u, key_c, key_m)``), as ``tests/test_torch_seqs_train.py`` does.

Tolerances (fp32 on both sides, other reduction orders): tables, data,
DAGs, posteriors, states and masks bitwise; log R to 1e-6; MDB parts to
1e-5 relative; one iteration's actions bitwise, loss and gradients to 1e-4
relative with 1e-5 absolute; the JSD to 1e-5 relative.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward_rollout  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs.dag import DAGEnvironment as JaxDAG  # noqa: E402
from repro.recipes import dag as jax_dag_recipe  # noqa: E402
from repro.rewards import bayesnet as jbn  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.objectives import (evaluate_trajectory,  # noqa: E402
                                         objective_parts)
from repro_torch.core.rollout import RolloutBatch  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.recipes import dag as dag_recipe  # noqa: E402
from repro_torch.recipes import get_train  # noqa: E402
from repro_torch.rewards import bayesnet as tbn  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 8
EPS = 0.5            # explore on about half the rows: both branches run


def _np(x):
    return np.array(x)


def _pair(d=3, score="bge", num_samples=50, seed=1):
    jrm = jbn.BayesNetRewardModule(d=d, num_samples=num_samples, score=score,
                                   seed=seed)
    jenv = JaxDAG(reward_module=jrm, d=d)
    tenv = dag_recipe.dag_env(d=d, score=score, num_samples=num_samples,
                              seed=seed)
    return jenv, jenv.init(jax.random.PRNGKey(0)), tenv, tenv.init(CPU)


# -- the reward: dataset, tables, enumeration, posterior -------------------------

@pytest.mark.parametrize("d,seed", [(3, 1), (5, 0), (6, 4)])
def test_dataset_and_score_tables_are_bitwise_jax(d, seed):
    rm = tbn.BayesNetRewardModule(d=d, seed=seed)
    adj, X = rm.dataset()
    rng = np.random.RandomState(seed)
    jadj = jbn.sample_erdos_renyi_dag(rng, d)
    jX = jbn.sample_linear_gaussian_data(rng, jadj, 100, 0.1)
    np.testing.assert_array_equal(adj, jadj)
    np.testing.assert_array_equal(X, jX)
    assert tbn.topological_order(adj) == jbn.topological_order(jadj)
    np.testing.assert_array_equal(tbn.bge_score_table(X),
                                  jbn.bge_score_table(jX))
    np.testing.assert_array_equal(tbn.linear_gaussian_score_table(X),
                                  jbn.linear_gaussian_score_table(jX))


@pytest.mark.parametrize("score", ["bge", "lingauss"])
def test_reward_params_are_jax(score):
    jenv, jp, _, tp = _pair(d=5, score=score, num_samples=100, seed=0)
    rp = tp.reward_params
    for k in ("table", "empty_score", "true_adj", "data"):
        assert rp[k].dtype == {"table": torch.float32,
                               "empty_score": torch.float32,
                               "true_adj": torch.int8,
                               "data": torch.float32}[k], k
        np.testing.assert_array_equal(rp[k].numpy(), _np(jp[k]), err_msg=k)


@pytest.mark.parametrize("d,count", [(2, 3), (3, 25), (4, 543)])
def test_enumerate_dags_counts_and_order_are_jax(d, count):
    dags = tbn.enumerate_dags(d)
    assert dags.shape == (count, d, d) and dags.dtype == np.int8
    np.testing.assert_array_equal(dags, jbn.enumerate_dags(d))
    codes = dag_recipe.dag_codes(torch.as_tensor(dags))
    assert bool((codes[1:] > codes[:-1]).all())


def test_posterior_and_marginals_are_bitwise_jax():
    _, jp, _, tp = _pair(d=4, seed=2)
    dags = tbn.enumerate_dags(4)
    table = tp.reward_params["table"].numpy()
    post = tbn.exact_posterior(dags, table)
    np.testing.assert_array_equal(post, jbn.exact_posterior(
        dags, np.asarray(jp["table"])))
    np.testing.assert_array_equal(tbn.dag_log_scores(dags, table),
                                  jbn.dag_log_scores(dags, table))
    for name in ("edge_marginals", "path_marginals",
                 "markov_blanket_marginals"):
        np.testing.assert_array_equal(getattr(tbn, name)(dags, post),
                                      getattr(jbn, name)(dags, post),
                                      err_msg=name)


def test_reward_module_log_reward_matches_jax():
    _, jp, tenv, tp = _pair(d=4, seed=2)
    rng = np.random.RandomState(0)
    dags = tbn.enumerate_dags(4)[rng.choice(543, 32)]
    pa = (dags.astype(np.int64) * (1 << np.arange(4))[:, None]).sum(1)
    got = tenv.reward_module.log_reward(torch.as_tensor(pa, dtype=torch.int32),
                                        tp.reward_params)
    want = jbn.BayesNetRewardModule(d=4).log_reward(
        jnp.asarray(pa, jnp.int32), jp)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


# -- the environment ---------------------------------------------------------------

def _assert_states_equal(ts, js, what):
    for name in ("adj", "reach", "pa_mask", "num_edges", "stopped", "steps"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      _np(getattr(js, name)),
                                      err_msg=f"{what} {name}")
    np.testing.assert_allclose(ts.log_r.numpy(), _np(js.log_r), rtol=1e-6,
                               err_msg=f"{what} log_r")


def _pick(mask, rng):
    """One legal action per row (the first action of an all-illegal row)."""
    return np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                     for m in mask])


def test_steps_masks_and_closure_match_jax():
    """Forward steps from the empty graph to the end of the episode with
    random legal actions (stop included), then backward steps (un-stop,
    edge removals, so the closure is rebuilt) back to the empty graph:
    every state, mask and observation bitwise, log R to 1e-6, and log R
    equal to the reward module's direct lookup."""
    d, n = 4, 16
    jenv, jp, tenv, tp = _pair(d=d, seed=3)
    jstep = jax.jit(lambda s, a: jenv.step(s, a, jp)[1])
    jback = jax.jit(lambda s, a: jenv.backward_step(s, a, jp)[1])
    jmasks = jax.jit(lambda s: (jenv.forward_mask(s, jp),
                                jenv.backward_mask(s, jp),
                                jenv.observe(s, jp)))
    _, js = jenv.reset(n, jp)
    _, ts = tenv.reset(n, tp)
    rng = np.random.RandomState(0)
    saw_stop = saw_removal = False
    for t in range(tenv.max_steps):
        fm, bm, obs = jmasks(js)
        np.testing.assert_array_equal(tenv.forward_mask(ts, tp).numpy(),
                                      _np(fm), err_msg=f"fwd mask {t}")
        np.testing.assert_array_equal(tenv.backward_mask(ts, tp).numpy(),
                                      _np(bm), err_msg=f"bwd mask {t}")
        np.testing.assert_array_equal(tenv.observe(ts, tp).numpy(), _np(obs))
        # stop early on a few rows (stop is legal until stopped), take a
        # legal edge on the rest while there is one
        fmask = _np(fm).copy()
        has_edge = fmask[:, :-1].any(-1)
        fmask[has_edge & (rng.rand(n) > 0.15), -1] = False
        a = _pick(fmask, rng)
        saw_stop |= bool((a == tenv.stop_action).any())
        js = jstep(js, jnp.asarray(a, jnp.int32))
        _, ts, _, _ = tenv.step(ts, torch.as_tensor(a), tp)
        _assert_states_equal(ts, js, f"forward {t}")
    assert saw_stop and bool(ts.stopped.all())
    direct = tenv.reward_module.log_reward(ts.pa_mask, tp.reward_params)
    np.testing.assert_allclose(tenv.log_reward(ts, tp).numpy(),
                               direct.numpy(), rtol=1e-6)
    for t in range(tenv.max_steps):
        bm = _np(jmasks(js)[1])
        a = _pick(bm, rng)
        saw_removal |= bool((a < tenv.stop_action).any())
        js = jback(js, jnp.asarray(a, jnp.int32))
        _, ts, _, _ = tenv.backward_step(ts, torch.as_tensor(a), tp)
        _assert_states_equal(ts, js, f"backward {t}")
    assert saw_removal and bool(tenv.is_initial(ts, tp).all())


def test_stop_action_log_r_is_finite():
    """The stop action reads the -inf entry table[d-1, mask | 1 << (d-1)];
    the select keeps log R finite, and a stopped row stays where it is."""
    _, _, tenv, tp = _pair(d=3)
    assert torch.isinf(tp.reward_params["table"]).any()
    _, s = tenv.reset(4, tp)
    a = torch.tensor([tenv.stop_action, 1, 5, tenv.stop_action])
    _, s, log_r, done = tenv.step(s, a, tp)
    assert torch.isfinite(s.log_r).all() and torch.isfinite(log_r).all()
    assert done.tolist() == [True, False, False, True]
    _, s2, _, _ = tenv.step(s, torch.tensor([1, 2, 1, 2]), tp)
    assert torch.equal(s2.adj[0], s.adj[0]) and torch.equal(s2.log_r[[0, 3]],
                                                             s.log_r[[0, 3]])


# -- MDB and one iteration ----------------------------------------------------------

@jax.jit
def _replay_rows(k_sample, ids, ts, shape_ta):
    T, A = shape_ta.shape
    step_keys = jax.random.split(k_sample, T)

    def one(i, t):
        env_key = jax.random.fold_in(step_keys[t], i)
        key_u, key_c, key_m = jax.random.split(env_key, 3)
        return (jax.random.gumbel(key_c, (A,)),
                jax.random.gumbel(key_u, (A,)),
                jax.random.uniform(key_m, ()))

    return jax.vmap(one)(ids, ts)


def replay_step_noise(k_sample, T):
    def noise(seed, index, t, num_actions):
        g, gu, u = _replay_rows(k_sample, jnp.asarray(index.numpy(),
                                                      jnp.int32),
                                jnp.asarray(t.numpy(), jnp.int32),
                                jnp.zeros((T, num_actions)))
        return StepNoise(torch.from_numpy(_np(g)), torch.from_numpy(_np(gu)),
                         torch.from_numpy(_np(u)))

    return noise


def _batch_to_torch(jb) -> RolloutBatch:
    f = lambda x: torch.from_numpy(_np(x))
    return RolloutBatch(
        obs=f(jb.obs), fwd_mask=f(jb.fwd_mask), bwd_mask=f(jb.bwd_mask),
        actions=f(jb.actions).long(), bwd_actions=f(jb.bwd_actions).long(),
        valid=f(jb.valid), done=f(jb.done), log_reward=f(jb.log_reward),
        log_r_state=f(jb.log_r_state), energy=f(jb.energy),
        log_pf_beh=f(jb.log_pf_beh))


def _jax_policy(jenv):
    return make_mlp_policy(jenv.d ** 2, jenv.action_dim,
                           jenv.backward_action_dim, hidden=(128, 128),
                           learn_backward=True)


@pytest.fixture(scope="module")
def iteration():
    """One iteration of dag_mdb at d = 3 (the recipe's policy and config,
    epsilon 0.5) on both packages from JAX's parameters and noise."""
    jenv, jp, tenv, tp = _pair(d=3)
    jpol = _jax_policy(jenv)
    key = jax.random.PRNGKey(7)
    jparams = jpol.init(jax.random.split(key)[0])
    k_sample = jax.random.split(jax.random.split(key)[1])[1]
    cfg = dag_recipe.dag_config(tenv, B, 100)._replace(exploration_eps=EPS)
    jcfg = JaxGFNConfig(**cfg._asdict())
    jb = jax.jit(lambda p, k: jax_forward_rollout(
        k, jenv, jp, jpol, p, B, exploration_eps=jnp.float32(EPS)))(
        jparams, k_sample)
    (jnum, jden), jgrads = jax.jit(jax.value_and_grad(
        jax_parts_fn(jenv, jpol, jcfg), has_aux=True))(jparams, jb)
    jden = jnp.maximum(jden, 1.0)
    tpol = dag_recipe.dag_policy(tenv, device=CPU, requires_grad=True)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    loop = TrainLoop(tenv, tp, tpol, cfg, sampler=OnPolicySampler(
        noise=replay_step_noise(k_sample, tenv.max_steps)))
    batch = loop.sample(loop.init(seed=0))
    loss = float(loop.loss_and_grads(batch))
    return {"jb": jb, "jparams": jparams, "jpol": jpol, "jloss":
            float(jnum / jden),
            "jgrads": params_from_jax(jax.tree_util.tree_map(
                lambda g: _np(g / jden), jgrads)),
            "batch": batch, "loss": loss, "tpol": tpol,
            "grads": {n: p.grad.clone()
                      for n, p in tpol.params.flat().items()}}


def test_batch_matches_jax(iteration):
    jb, tb = iteration["jb"], iteration["batch"]
    for name in ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
                 "valid", "done"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      _np(getattr(jb, name)), err_msg=name)
    for name in ("log_reward", "log_r_state", "log_pf_beh"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   _np(getattr(jb, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # every state's log R is carried; the DAG env has no energy
    assert bool((tb.log_r_state != 0).all())
    assert not tb.energy.any()
    assert tb.actions.eq(iteration["tpol"].action_dim - 1).any()


def test_mdb_parts_match_jax(iteration):
    """``objective_parts("mdb")`` on JAX's own batch (the stop-action
    branch of evaluate_trajectory: plain log-softmax, log P_F(stop))."""
    jb, jpol, jparams = iteration["jb"], iteration["jpol"], iteration["jparams"]
    stop = iteration["tpol"].action_dim - 1
    jev = jobj.evaluate_trajectory(jpol, jparams, jb, stop_action=stop)
    jnum, jden = jobj.mdb_parts(jev, jb)
    tb = _batch_to_torch(jb)
    tev = evaluate_trajectory(iteration["tpol"], tb, stop_action=stop)
    for name in ("log_pf", "log_pb", "log_flow", "log_pf_stop"):
        np.testing.assert_allclose(getattr(tev, name).detach().numpy(),
                                   _np(getattr(jev, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    num, den = objective_parts("mdb")(tev, tb, iteration["tpol"].params,
                                      None)
    np.testing.assert_allclose(float(num.detach()), float(jnum), rtol=1e-5)
    assert float(den) == float(jden) > 0


def test_loss_and_gradients_match_jax(iteration):
    np.testing.assert_allclose(iteration["loss"], iteration["jloss"],
                               rtol=1e-4, atol=1e-5)
    grads, jgrads = iteration["grads"], iteration["jgrads"]
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -- the JSD against the exact posterior ----------------------------------------------

@pytest.mark.parametrize("d", [3, 4])
def test_device_jsd_equals_jax_make_eval_on_the_same_samples(d, monkeypatch):
    """The JAX recipe's ``make_eval`` (host hashing of each sample) and the
    port's :class:`PosteriorJSDEval` (codes searched on the device) on the
    same 4,000 DAGs, drawn from a tilted posterior."""
    jenv, jp, tenv, tp = _pair(d=d, seed=2)
    dags = tbn.enumerate_dags(d)
    rng = np.random.RandomState(d)
    w = rng.rand(len(dags)) ** 4
    adj = dags[rng.choice(len(dags), 4000, p=w / w.sum())]
    monkeypatch.setattr(
        jax_dag_recipe, "forward_rollout",
        lambda *a, **k: types.SimpleNamespace(
            obs=[jnp.asarray(adj.reshape(4000, -1), jnp.float32)]))
    want = jax_dag_recipe._make_eval(
        jenv, jp, types.SimpleNamespace(apply=None), None)(None, None)["jsd"]
    ev = dag_recipe.PosteriorJSDEval(tenv, tp, policy=None)
    idx = ev.indices(torch.as_tensor(adj))
    assert torch.equal(ev.codes[idx], dag_recipe.dag_codes(
        torch.as_tensor(adj)))
    got = float(ev.jsd(torch.as_tensor(adj)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_device_jsd_runs_a_rollout():
    """``PosteriorJSDEval(seed)`` samples from the policy and returns a JSD
    in [0, log 2]; the enumerated DAGs index themselves."""
    _, _, tenv, tp = _pair(d=3)
    pol = dag_recipe.dag_policy(tenv, device=CPU)
    ev = dag_recipe.PosteriorJSDEval(tenv, tp, pol, num_samples=500)
    dags = torch.as_tensor(tbn.enumerate_dags(3))
    assert torch.equal(ev.indices(dags), torch.arange(25))
    jsd = float(ev(0)["jsd"])
    assert 0 < jsd <= np.log(2)
    assert float(ev.posterior.sum()) == pytest.approx(1.0, abs=1e-6)


# -- the CLI -------------------------------------------------------------------------

def test_cli_trains_dag_mdb_with_evals_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "dag_mdb", "--iterations", "3",
                           "--device", "cpu", "--set", "d=3",
                           "--num-envs", "8", "--eval-every", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("it ")]) == 3
    evals = [ln.split() for ln in out if ln.startswith("eval it ")]
    assert [int(e[2]) for e in evals] == [0, 2]
    for e in evals:
        got = dict(zip(e[3::2], map(float, e[4::2])))
        assert set(got) == {"pearson", "spearman", "elbo", "log_z_is"}
        assert all(np.isfinite(v) for v in got.values())
    rec = get_train("dag_mdb")
    assert (rec.iterations, rec.num_envs, rec.eval_every) == (100000, 128,
                                                             2000)


def test_cli_refuses_to_run_dag_mdb_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "dag_mdb", "--iterations", "1",
                        "--set", "d=3"])
