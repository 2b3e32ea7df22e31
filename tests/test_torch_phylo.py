"""The port's phylogenetic-tree generation against the JAX package's: the
synthetic alignment and pair table (bitwise), Fitch merges, splits, masks,
energies and observations on the reduced alignment (10 species, 100
sites), the slot-transformer policy with JAX's parameters carried across,
FLDB's parts on a JAX batch, one ``phylo_fldb`` iteration (2 encoder
layers) with JAX's noise replayed, and the CLI.

Noise: a step-noise source that replays JAX's draws (env e at step t folds
``split(k_sample, T)[t]`` with e and splits the result into
``(key_u, key_c, key_m)``), as ``tests/test_torch_seqs_train.py`` does.

Tolerances (fp32 on both sides, other reduction orders): alignment, pair
table, states and masks bitwise; observations, energies and log R to
1e-6; policy heads to 1e-5; FLDB parts to 1e-5 relative; one iteration's
actions bitwise, loss and gradients to 1e-4 relative with 1e-5 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.policies import make_phylo_policy  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward_rollout  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs import phylo as jphylo  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.objectives import (evaluate_trajectory,  # noqa: E402
                                         objective_parts)
from repro_torch.core.policies import PhyloPolicy  # noqa: E402
from repro_torch.core.rollout import RolloutBatch  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs import phylo as tphylo  # noqa: E402
from repro_torch.recipes import get_train  # noqa: E402
from repro_torch.recipes import phylo as phylo_recipe  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 6
EPS = 0.5            # explore on about half the rows: both branches run
SMALL = dict(num_layers=2)    # Table 6 widths (32, 8 heads, MLP 128)


def _np(x):
    return np.array(x)


def _pair():
    """JAX's reduced phylo env (``repro.recipes.phylo``'s reduced=True)
    and the port's."""
    jenv = jphylo.PhyloEnvironment(n_species=10, n_sites=100, alpha=4.0,
                                   reward_c=100.0, seed=0)
    tenv = phylo_recipe.phylo_env(reduced=True)
    return jenv, jenv.init(jax.random.PRNGKey(0)), tenv, tenv.init(CPU)


# -- the dataset ---------------------------------------------------------------

@pytest.mark.parametrize("seed,n,s", [(0, 10, 100), (100, 27, 1949),
                                      (3, 5, 8)])
def test_alignment_is_bitwise_jax(seed, n, s):
    got = tphylo.synth_alignment(seed, n, s)
    assert got.dtype == np.int32 and got.shape == (n, s)
    np.testing.assert_array_equal(got, jphylo.synth_alignment(seed, n, s))


def test_pair_table_and_datasets_are_jax():
    for k in (5, 19, 53):
        for got, want in zip(tphylo.make_pair_table(k),
                             jphylo.make_pair_table(k)):
            np.testing.assert_array_equal(got, want)
    assert tphylo.DS_DIMS == jphylo.DS_DIMS
    assert tphylo.DS_REWARD_C == jphylo.DS_REWARD_C
    for ds in range(1, 9):
        t = tphylo.PhyloEnvironment.from_dataset(ds)
        j = jphylo.PhyloEnvironment.from_dataset(ds)
        assert (t.n, t.sites, t.reward_c, t.seed, t.action_dim,
                t.backward_action_dim, t.max_steps) == (
            j.n, j.sites, j.reward_c, j.seed, j.action_dim,
            j.backward_action_dim, j.max_steps)
    ds1 = phylo_recipe.phylo_env()
    assert (ds1.n, ds1.sites, ds1.seed, ds1.action_dim) == (27, 1949, 100,
                                                            1378)


# -- the environment --------------------------------------------------------------

def _pick(mask, rng):
    return np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                     for m in mask])


def _assert_states_equal(ts, js, what):
    """JAX's state fields bitwise; the port's carried histogram
    (``node_hist``, which JAX recomputes from the Fitch sets at every
    observation) equal to the counts of JAX's Fitch sets."""
    for name in ("node_fitch", "node_children", "node_mut", "root_mask",
                 "score", "merges", "steps"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      _np(getattr(js, name)),
                                      err_msg=f"{what} {name}")
    counts = (_np(js.node_fitch)[..., None] == np.arange(1, 16)).sum(-2)
    np.testing.assert_array_equal(ts.node_hist.numpy(), counts,
                                  err_msg=f"{what} node_hist")


def test_merges_splits_masks_and_observations_match_jax():
    """Random legal merges to the full tree, then random legal splits back
    to the forest: states and masks bitwise; observations, energies and
    log R to 1e-6; the backward action of each merge and the forward
    action of each split equal JAX's."""
    n = 12
    jenv, jp, tenv, tp = _pair()
    jit = lambda f: jax.jit(lambda *a: f(*a, jp))
    jstep = jit(lambda s, a, p: jenv.step(s, a, p)[1])
    jback = jit(lambda s, a, p: jenv.backward_step(s, a, p)[1])
    jview = jit(lambda s, p: (jenv.observe(s, p), jenv.forward_mask(s, p),
                              jenv.backward_mask(s, p), jenv.energy(s, p),
                              jenv.log_reward(s, p)))
    jbwd_a = jit(lambda s, a, ns, p: jenv.get_backward_action(s, a, ns, p))
    jfwd_a = jit(lambda s, a, ps, p: jenv.get_forward_action(s, a, ps, p))
    _, js = jenv.reset(n, jp)
    _, ts = tenv.reset(n, tp)
    _assert_states_equal(ts, js, "reset")
    rng = np.random.RandomState(0)

    def compare(what):
        obs, fm, bm, en, lr = jview(js)
        np.testing.assert_allclose(tenv.observe(ts, tp).numpy(), _np(obs),
                                   rtol=1e-6, atol=1e-6, err_msg=what)
        np.testing.assert_array_equal(tenv.forward_mask(ts, tp).numpy(),
                                      _np(fm), err_msg=what)
        np.testing.assert_array_equal(tenv.backward_mask(ts, tp).numpy(),
                                      _np(bm), err_msg=what)
        np.testing.assert_allclose(tenv.energy(ts, tp).numpy(), _np(en),
                                   rtol=1e-6, atol=1e-6, err_msg=what)
        np.testing.assert_allclose(tenv.log_reward(ts, tp).numpy(), _np(lr),
                                   rtol=1e-6, err_msg=what)
        return _np(fm), _np(bm)

    for t in range(tenv.max_steps):
        fm, _ = compare(f"forward {t}")
        a = _pick(fm, rng)
        ja = jnp.asarray(a, jnp.int32)
        js_next = jstep(js, ja)
        _, ts_next, _, _ = tenv.step(ts, torch.as_tensor(a), tp)
        np.testing.assert_array_equal(
            tenv.get_backward_action(ts, torch.as_tensor(a), ts_next,
                                     tp).numpy(),
            _np(jbwd_a(js, ja, js_next)), err_msg=f"backward action {t}")
        js, ts = js_next, ts_next
        _assert_states_equal(ts, js, f"forward {t}")
    assert bool(tenv.is_terminal(ts, tp).all())
    # the terminal energy is -log R, the initial one 0
    np.testing.assert_allclose(tenv.energy(ts, tp).numpy(),
                               -tenv.log_reward(ts, tp).numpy(), rtol=1e-6)
    for t in range(tenv.max_steps):
        _, bm = compare(f"backward {t}")
        a = _pick(bm, rng)
        ja = jnp.asarray(a, jnp.int32)
        js_prev = jback(js, ja)
        _, ts_prev, _, _ = tenv.backward_step(ts, torch.as_tensor(a), tp)
        np.testing.assert_array_equal(
            tenv.get_forward_action(ts, torch.as_tensor(a), ts_prev,
                                    tp).numpy(),
            _np(jfwd_a(js, ja, js_prev)), err_msg=f"forward action {t}")
        js, ts = js_prev, ts_prev
        _assert_states_equal(ts, js, f"backward {t}")
    assert bool(tenv.is_initial(ts, tp).all())
    assert not tenv.energy(ts, tp).any()


# -- the policy, FLDB and one iteration ---------------------------------------------

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


@pytest.fixture(scope="module")
def iteration():
    """One iteration of phylo_fldb on the reduced alignment with a 2-layer
    policy (the recipe's config, epsilon 0.5) on both packages from JAX's
    parameters and noise."""
    jenv, jp, tenv, tp = _pair()
    jpol = make_phylo_policy(jenv, **SMALL)
    key = jax.random.PRNGKey(7)
    jparams = jpol.init(jax.random.split(key)[0])
    k_sample = jax.random.split(jax.random.split(key)[1])[1]
    cfg = phylo_recipe.phylo_config(tenv, B, 100)._replace(
        exploration_eps=EPS)
    jb = jax.jit(lambda p, k: jax_forward_rollout(
        k, jenv, jp, jpol, p, B, exploration_eps=jnp.float32(EPS)))(
        jparams, k_sample)
    (jnum, jden), jgrads = jax.jit(jax.value_and_grad(
        jax_parts_fn(jenv, jpol, JaxGFNConfig(**cfg._asdict())),
        has_aux=True))(jparams, jb)
    jden = jnp.maximum(jden, 1.0)
    tpol = PhyloPolicy(tenv, device=CPU, requires_grad=True, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    loop = TrainLoop(tenv, tp, tpol, cfg, sampler=OnPolicySampler(
        noise=replay_step_noise(k_sample, tenv.max_steps)))
    batch = loop.sample(loop.init(seed=0))
    loss = float(loop.loss_and_grads(batch))
    return {"jb": jb, "jparams": jparams, "jpol": jpol,
            "jloss": float(jnum / jden),
            "jgrads": params_from_jax(jax.tree_util.tree_map(
                lambda g: _np(g / jden), jgrads)),
            "batch": batch, "loss": loss, "tpol": tpol,
            "grads": {n: p.grad.clone()
                      for n, p in tpol.params.flat().items()}}


def test_policy_heads_match_jax(iteration):
    """Every leaf carried across by name; logits, backward logits and the
    flow on JAX's observations."""
    jb, jpol, jparams = iteration["jb"], iteration["jpol"], iteration["jparams"]
    tpol = iteration["tpol"]
    assert set(tpol.params.flat()) == set(params_from_jax(
        jax.device_get(jparams)))
    obs = _np(jb.obs).reshape((-1,) + jb.obs.shape[2:])
    want = jax.jit(jpol.apply)(jparams, jnp.asarray(obs))
    with torch.no_grad():
        got = tpol.apply(torch.from_numpy(obs))
    for k in ("logits", "logits_b", "log_flow"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_batch_matches_jax(iteration):
    jb, tb = iteration["jb"], iteration["batch"]
    for name in ("fwd_mask", "bwd_mask", "actions", "bwd_actions", "valid",
                 "done"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      _np(getattr(jb, name)), err_msg=name)
    for name in ("obs", "log_reward", "energy", "log_pf_beh"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   _np(getattr(jb, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the phylo env's states are not terminal: no per-state reward
    assert not tb.log_r_state.any() and tb.energy[1:].any()


def test_fldb_parts_match_jax(iteration):
    """``objective_parts("fldb")`` on JAX's own batch (the no-stop branch of
    evaluate_trajectory: the traj_logprob wrapper's plain version)."""
    jb, jpol, jparams = iteration["jb"], iteration["jpol"], iteration["jparams"]
    jev = jobj.evaluate_trajectory(jpol, jparams, jb)
    jnum, jden = jobj.fldb_parts(jev, jb)
    tb = _batch_to_torch(jb)
    tev = evaluate_trajectory(iteration["tpol"], tb)
    for name in ("log_pf", "log_pb", "log_flow"):
        np.testing.assert_allclose(getattr(tev, name).detach().numpy(),
                                   _np(getattr(jev, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    num, den = objective_parts("fldb")(tev, tb, iteration["tpol"].params,
                                       None)
    np.testing.assert_allclose(float(num.detach()), float(jnum), rtol=1e-5)
    assert float(den) == float(jden) == B * 9


def test_loss_and_gradients_match_jax(iteration):
    """Loss and every gradient; the traj_logprob backward (plain
    version here) gives P_F's and P_B's.  ``bwd_head/b`` shifts every
    backward logit alike, which the softmax ignores: its gradient is 0 up
    to rounding (~1e-8) in both packages, held by the absolute bound."""
    np.testing.assert_allclose(iteration["loss"], iteration["jloss"],
                               rtol=1e-4, atol=1e-5)
    grads, jgrads = iteration["grads"], iteration["jgrads"]
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -- the CLI -------------------------------------------------------------------------

def test_cli_trains_phylo_fldb_with_evals_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "phylo_fldb", "--iterations", "3",
                           "--device", "cpu", "--set", "reduced=True",
                           "--num-envs", "4", "--eval-every", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("it ")]) == 3
    evals = [ln.split() for ln in out if ln.startswith("eval it ")]
    assert [int(e[2]) for e in evals] == [0, 2]
    for e in evals:
        got = dict(zip(e[3::2], map(float, e[4::2])))
        assert set(got) == {"pearson", "spearman"}
        assert all(-1 <= v <= 1 for v in got.values())
    rec = get_train("phylo_fldb")
    assert (rec.iterations, rec.num_envs, rec.eval_every) == (100000, 32,
                                                             500)


def test_cli_refuses_to_run_phylo_fldb_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "phylo_fldb", "--iterations", "1",
                        "--set", "reduced=True"])
