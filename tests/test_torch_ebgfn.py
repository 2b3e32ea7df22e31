"""The port's EB-GFN loop and ``ising_ebgfn`` recipe against the JAX
package's: three iterations at n = 3 (8 envs, MLP 2x32 with a learned P_B)
from JAX's parameters with every JAX draw replayed (the four rollouts'
actions, the mix coin, the TB loss and its gradients, the MH log ratio and
test, J after each iteration), the default noise streams, the data-row
table, the two run modes, the parameter carry-over and the CLI.

Noise: one source per draw of the iteration, each replaying the JAX key
that draw takes in ``make_ebgfn_step``'s ``step_fn``: the mixed rollout's
three (forward, backward-from-data, the mix coin) and the EBM step's two
(the negatives' forward rollout; the MH backward rollout, whose key JAX
also hands to the MH uniforms).  The JAX side's intermediates come from
the same calls in the same order (``jax_parts``), held against JAX's own
``step_fn`` where both give a value.

Tolerances (fp32 on both sides, other reduction orders): actions, coins
and data rows bitwise; the loss and gradients to 1e-4 relative with 1e-5
absolute; log A to 1e-4; the MH test equal where |log u - log A| > 1e-3;
J to 1e-4 relative with 1e-6 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ebgfn as jeb  # noqa: E402
from repro.core.objectives import evaluate_trajectory as jax_eval  # noqa: E402
from repro.core.objectives import tb_loss as jax_tb_loss  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.rollout import backward_rollout as jax_backward  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward  # noqa: E402
from repro.envs import ising as jising  # noqa: E402
from repro.recipes.ising import _make_env as jax_recipe_env  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.ebgfn import (EBGFN_NOISE, EBGFNLoop,  # noqa: E402
                                    EBGFNNoise, data_rows, neg_log_rmse,
                                    symmetrize)
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.types import train_seed  # noqa: E402
from repro_torch.envs import ising as tising  # noqa: E402
from repro_torch.recipes import get_train, train_names  # noqa: E402
from repro_torch.recipes import ising as ising_recipe  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, SIGMA, NUM_DATA, B, HIDDEN, SEED, ITERS = 3, -0.1, 50, 8, (32, 32), 3, 3
ALPHA = 0.5


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(_np(x))


# -- replayed draws ---------------------------------------------------------------

@jax.jit
def _gumbel_rows(key, ids, ts, shape_ta):
    """The categorical draw (``key_c``) of env ids[r] at step ts[r] of a
    non-exploring rollout keyed ``key`` over T steps."""
    T, A = shape_ta.shape
    step_keys = jax.random.split(key, T)

    def one(i, t):
        _, key_c, _ = jax.random.split(jax.random.fold_in(step_keys[t], i), 3)
        return jax.random.gumbel(key_c, (A,))

    return jax.vmap(one)(ids, ts)


def _iteration(seed):
    """The iteration a loop seed tensor names (``train_seed``'s low bits)."""
    return int(seed.reshape(-1)[0]) & 0xFFFFFFFF


def replay_rollout(keys, name, T):
    def noise(seed, index, t, num_actions):
        key = keys[_iteration(seed)][name]
        return _t(_gumbel_rows(key, jnp.asarray(index.numpy(), jnp.int32),
                               jnp.asarray(t.numpy(), jnp.int32),
                               jnp.zeros((T, num_actions))))
    return noise


def replay_coin(keys, name):
    def coin(seed, index):
        u = jax.random.uniform(keys[_iteration(seed)][name], (B,))
        return _t(u)[index]
    return coin


def jax_keys(seed, iterations):
    """Each iteration's keys as ``step_fn`` splits them."""
    out, key = [], jax.random.PRNGKey(seed)
    for _ in range(iterations):
        key, k1, k2 = jax.random.split(key, 3)
        ka, kb, kc = jax.random.split(k1, 3)
        e1, e2 = jax.random.split(k2)
        out.append(dict(fwd=ka, bwd=kb, take=kc, neg=e1, mh=e2))
    return out


# -- three iterations on both packages ---------------------------------------------

def _jax_parts(jenv, jpol):
    """JAX's iteration, call for call as ``make_ebgfn_step`` makes it, with
    its intermediates: from the state before (``st``) and, for the EBM
    half, the policy after the GFN update (``st_next``'s)."""
    def parts(st, st_next, data):
        _, k1, k2 = jax.random.split(st.key, 3)
        env_params = {"J": jeb.symmetrize(st.ebm_params["J"])}
        ka, kb, kc = jax.random.split(k1, 3)
        p = st.gfn.params
        term = jenv.terminal_state_from_spins(data)
        fwd = jax_forward(ka, jenv, env_params, jpol, p, B)
        bwd = jax_backward(kb, jenv, env_params, jpol, p, term, collect=True,
                           with_log_pf=False).batch
        take = jax.random.uniform(kc, (B,)) < ALPHA
        batch = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                take.reshape((1, B) + (1,) * (a.ndim - 2))
                if a.ndim >= 2 else take, a, b), fwd, bwd)
        loss, grads = jax.value_and_grad(lambda q: jax_tb_loss(
            jax_eval(jpol.apply, q, batch), batch, q["log_z"]))(p)
        e1, e2 = jax.random.split(k2)
        q = st_next.gfn.params
        neg = jax_forward(e1, jenv, env_params, jpol, q, B)
        mh = jax_backward(e2, jenv, env_params, jpol, q, term, collect=True)
        J = env_params["J"]
        energy = lambda x: -jnp.einsum('bi,ij,bj->b', x, J, x)  # noqa: E731
        log_a = (energy(data.astype(jnp.float32)) - energy(neg.obs[-1])) \
            + ((mh.log_pf - mh.log_pb) - jnp.sum(
                jnp.where(neg.valid, neg.log_pf_beh, 0.0), axis=0))
        log_u = jnp.log(jax.random.uniform(e2, (B,)))
        return dict(take=take, fwd=fwd.actions, bwd=bwd.actions,
                    bwd_b=bwd.bwd_actions, neg=neg.actions,
                    mh=mh.batch.bwd_actions, loss=loss, grads=grads,
                    log_a=log_a, log_u=log_u)
    return jax.jit(parts)


@pytest.fixture(scope="module")
def runs():
    jenv = jising.IsingEnvironment(n=N, sigma=SIGMA)
    tenv = tising.IsingEnvironment(n=N, sigma=SIGMA)
    data = jising.generate_ising_dataset(0, N, SIGMA, NUM_DATA)
    jpol = make_mlp_policy(jenv.D, jenv.action_dim, jenv.backward_action_dim,
                           hidden=HIDDEN, learn_backward=True)
    init_fn, step_fn = jeb.make_ebgfn_step(jenv, jpol, num_envs=B)
    st = init_fn(jax.random.PRNGKey(SEED), jnp.asarray(data))
    step_fn, parts = jax.jit(step_fn), _jax_parts(jenv, jpol)
    keys = jax_keys(SEED, ITERS)
    tpol = MLPPolicy(tenv.D, tenv.action_dim, tenv.backward_action_dim,
                     hidden=HIDDEN, learn_backward=True, device=CPU,
                     requires_grad=True)
    tpol.load_params(params_from_jax(jax.device_get(st.gfn.params)))
    T = tenv.max_steps
    noise = EBGFNNoise(
        fwd=replay_rollout(keys, "fwd", T), bwd=replay_rollout(keys, "bwd", T),
        take=replay_coin(keys, "take"), neg=replay_rollout(keys, "neg", T),
        mh_bwd=replay_rollout(keys, "mh", T), mh_u=replay_coin(keys, "mh"))
    loop = EBGFNLoop(tenv, tpol, torch.from_numpy(data), iterations=ITERS,
                     num_envs=B, noise=noise)
    state = loop.init(SEED)
    rng = np.random.RandomState(SEED)
    out = []
    for it in range(ITERS):
        jdata = jnp.asarray(data[rng.randint(0, NUM_DATA, B)])
        st_next, jm = step_fn(st, jdata)
        j = parts(st, st_next, jdata)
        metrics, batch, trace = loop.iteration_trace(state)
        seed = torch.tensor(train_seed(SEED, it))
        mh = loop.mh_test(seed, trace.reward, trace.data, collect=True)
        out.append(dict(
            jax=j, jax_metrics=jm, jax_J=_np(st_next.ebm_params["J"]),
            jax_data=_np(jdata), trace=trace, metrics=metrics, mh=mh,
            grads={k: p.grad.clone() for k, p in tpol.params.flat().items()},
            J=state.J.detach().clone()))
        st = st_next
    return out


def test_data_rows_and_coins_match_jax(runs):
    for it, r in enumerate(runs):
        np.testing.assert_array_equal(r["trace"].data.numpy(), r["jax_data"],
                                      err_msg=f"iteration {it}")
        np.testing.assert_array_equal(r["trace"].take_fwd.numpy(),
                                      _np(r["jax"]["take"]),
                                      err_msg=f"iteration {it}")
    takes = np.concatenate([_np(r["jax"]["take"]) for r in runs])
    assert takes.any() and not takes.all()    # both kinds of rows train


def test_actions_of_the_four_rollouts_match_jax(runs):
    """The GFN forward rollout, the collecting backward rollout from data
    (its forward and backward actions), the negatives' forward rollout and
    the MH backward rollout (the MH test re-run collecting on the same
    draws: its negatives and totals equal the iteration's bitwise)."""
    for it, r in enumerate(runs):
        tr, j = r["trace"], r["jax"]
        for got, want, name in ((tr.fwd.actions, j["fwd"], "fwd"),
                                (tr.bwd.actions, j["bwd"], "bwd"),
                                (tr.bwd.bwd_actions, j["bwd_b"], "bwd_b"),
                                (tr.test.neg.actions, j["neg"], "neg"),
                                (r["mh"].mh.batch.bwd_actions, j["mh"],
                                 "mh")):
            np.testing.assert_array_equal(got.numpy(), _np(want),
                                          err_msg=f"iteration {it} {name}")
        assert torch.equal(r["mh"].neg.actions, tr.test.neg.actions)
        assert torch.equal(r["mh"].mh.log_pf, tr.test.mh.log_pf)
        assert torch.equal(r["mh"].mh.log_pb, tr.test.mh.log_pb)
        assert torch.equal(r["mh"].log_a, tr.test.log_a)


def test_tb_loss_and_gradients_match_jax(runs):
    for it, r in enumerate(runs):
        want = float(r["jax"]["loss"])
        np.testing.assert_allclose(float(r["metrics"]["gfn_loss"]), want,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r["jax_metrics"]["gfn_loss"]), want,
                                   rtol=1e-6)
        jgrads = params_from_jax(jax.device_get(r["jax"]["grads"]))
        assert set(jgrads) == set(r["grads"])
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), jgrads[k].numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"iteration {it} {k}")


def test_mh_test_matches_jax(runs):
    margins = []
    for it, r in enumerate(runs):
        tr, j = r["trace"].test, r["jax"]
        np.testing.assert_allclose(tr.log_a.numpy(), _np(j["log_a"]),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"iteration {it}")
        np.testing.assert_allclose(tr.log_u.numpy(), _np(j["log_u"]),
                                   rtol=1e-6)
        clear = np.abs(_np(j["log_u"]) - _np(j["log_a"])) > 1e-3
        margins.append(clear.sum())
        np.testing.assert_array_equal(
            tr.accept.numpy()[clear],
            (_np(j["log_u"]) < _np(j["log_a"]))[clear])
        np.testing.assert_allclose(
            float(r["metrics"]["mh_accept"]),
            float(r["jax_metrics"]["mh_accept"]), atol=1e-6)
    assert sum(margins) > 0


def test_J_after_each_iteration_matches_jax(runs):
    for it, r in enumerate(runs):
        np.testing.assert_allclose(r["J"].numpy(), r["jax_J"], rtol=1e-4,
                                   atol=1e-6, err_msg=f"iteration {it}")
    assert np.abs(runs[-1]["jax_J"]).max() > 0


# -- noise, data rows, modes ------------------------------------------------------

def test_default_noise_streams_differ_pairwise():
    """The six draws of one iteration: the four rollouts' Gumbel noise at
    the same (seed, row, step) and the two coins, all different."""
    seed = torch.full((B,), train_seed(4, 7), dtype=torch.int64)
    ids = torch.arange(B)
    t = torch.full((B,), 2)
    draws = {k: getattr(EBGFN_NOISE, k)(seed, ids, t, 9)
             for k in ("fwd", "bwd", "neg", "mh_bwd")}
    coins = {k: getattr(EBGFN_NOISE, k)(seed, ids) for k in ("take", "mh_u")}
    # each Gumbel stream's first column as the uniform it came from
    draws_u = {k: torch.exp(-torch.exp(-g[:, 0])) for k, g in draws.items()}
    for name, (a, b) in {
            "fwd/neg": (draws["fwd"], draws["neg"]),
            "bwd/mh_bwd": (draws["bwd"], draws["mh_bwd"]),
            "fwd/bwd": (draws["fwd"], draws["bwd"]),
            "fwd/mh_bwd": (draws["fwd"], draws["mh_bwd"]),
            "bwd/neg": (draws["bwd"], draws["neg"]),
            "neg/mh_bwd": (draws["neg"], draws["mh_bwd"]),
            "take/mh_u": (coins["take"], coins["mh_u"]),
            **{f"{c}/{k}": (coins[c], draws_u[k]) for c in coins
               for k in draws_u}}.items():
        assert not torch.isclose(a, b, rtol=1e-3, atol=0).any(), name
    for u in coins.values():
        assert bool(((u > 0) & (u < 1)).all())


def test_data_row_table_is_the_per_iteration_draws():
    rng = np.random.RandomState(11)
    want = np.stack([rng.randint(0, NUM_DATA, B) for _ in range(40)])
    np.testing.assert_array_equal(data_rows(11, NUM_DATA, B, 40), want)
    tenv = tising.IsingEnvironment(n=N, sigma=SIGMA)
    pol = ising_recipe.ising_policy(tenv, device=CPU, requires_grad=True)
    loop = ising_recipe.ising_loop(tenv, pol, seed=0, iterations=40,
                                   num_envs=B, num_data=NUM_DATA)
    state = loop.init(11)
    assert state.rows.dtype == torch.int64
    np.testing.assert_array_equal(state.rows.numpy(), want)
    # the loop's data are JAX's dataset
    np.testing.assert_array_equal(
        loop.data.numpy(), jising.generate_ising_dataset(0, N, SIGMA,
                                                         NUM_DATA))
    with pytest.raises(ValueError, match="data rows for 40 iterations"):
        loop.run(11, 41)


def _small_loop(seed=2):
    tenv = tising.IsingEnvironment(n=N, sigma=SIGMA)
    pol = MLPPolicy(tenv.D, tenv.action_dim, tenv.backward_action_dim,
                    hidden=HIDDEN, learn_backward=True, seed=seed,
                    device=CPU, requires_grad=True)
    return ising_recipe.ising_loop(tenv, pol, seed=0, iterations=ITERS,
                                   num_envs=B, num_data=NUM_DATA)


def test_scan_mode_logs_what_python_mode_returns():
    """``mode="scan"`` writes each iteration's metrics and log-rewards into
    device buffers; ``mode="python"`` hands the same to the callback; J
    and the policy end equal."""
    loop_p, loop_s = _small_loop(), _small_loop()
    st_p, hist = loop_p.run(5, ITERS, callback=lambda it, st, m, b: (
        {k: v.clone() for k, v in m.items()}, b.log_reward.clone()))
    st_s, (metrics, log_rewards) = loop_s.run(5, ITERS, mode="scan")
    assert set(metrics) == {"gfn_loss", "mh_accept"}
    for it, (m, lr) in enumerate(hist):
        for k in metrics:
            assert torch.equal(metrics[k][it], m[k]), (it, k)
        assert torch.equal(log_rewards[it], lr)
    trained_p, trained_s = loop_p.trained(st_p), loop_s.trained(st_s)
    assert set(trained_p) == set(trained_s) and "J" in trained_p
    for k in trained_p:
        assert torch.equal(trained_p[k], trained_s[k]), k
    assert int(st_s.counter) == ITERS and st_s.J.abs().max() > 0


def test_symmetrize_and_neg_log_rmse_match_jax():
    J = np.random.RandomState(0).randn(9, 9).astype(np.float32)
    J_true = 0.2 * tising.toroidal_adjacency(3)
    np.testing.assert_allclose(symmetrize(torch.from_numpy(J)).numpy(),
                               _np(jeb.symmetrize(jnp.asarray(J))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(neg_log_rmse(torch.from_numpy(J), torch.from_numpy(J_true))),
        float(jeb.neg_log_rmse(jnp.asarray(J), jnp.asarray(J_true))),
        rtol=1e-6)
    # J = 0 scores -log of the true J's RMSE
    zero = float(neg_log_rmse(torch.zeros(9, 9), torch.from_numpy(J_true)))
    np.testing.assert_allclose(zero, -np.log(0.2 * np.sqrt(4 / 9)),
                               rtol=1e-6)


def test_params_from_jax_carries_the_recipe_policy_and_J():
    """A JAX EB-GFN state at the recipe's size (n = 9, MLP 4x256 with a
    learned P_B): the policy's leaves load by name and apply as JAX's;
    ``ebm_params["J"]`` is the port's J."""
    jenv = jax_recipe_env()
    jpol = make_mlp_policy(jenv.D, jenv.action_dim, jenv.backward_action_dim,
                           hidden=(256,) * 4, learn_backward=True)
    init_fn, _ = jeb.make_ebgfn_step(jenv, jpol, num_envs=4)
    st = init_fn(jax.random.PRNGKey(1), jnp.zeros((4, jenv.D), jnp.int8))
    J = jnp.asarray(np.random.RandomState(1).randn(81, 81), jnp.float32)
    ebm = params_from_jax(jax.device_get({"J": J}))
    tenv = ising_recipe.ising_env()
    pol = ising_recipe.ising_policy(tenv, device=CPU)
    pol.load_params(params_from_jax(jax.device_get(st.gfn.params)))
    obs = np.random.RandomState(2).randint(-1, 2, (5, 81)).astype(np.float32)
    want = jpol.apply(st.gfn.params, jnp.asarray(obs))
    got = pol.apply(torch.from_numpy(obs))
    assert set(got) == set(want) == {"logits", "logits_b", "log_flow"}
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert set(ebm) == {"J"} and ebm["J"].dtype == torch.float32
    np.testing.assert_array_equal(ebm["J"].numpy(), _np(J))


# -- the recipe and the CLI ------------------------------------------------------

def test_recipe_defaults_are_jax():
    rec = get_train("ising_ebgfn")
    assert "ising_ebgfn" in train_names()
    assert (rec.iterations, rec.num_envs, rec.eval_every) == (20000, 256, 500)
    assert rec.run_override is ising_recipe.run
    env = rec.make_env()
    assert (env.n, env.sigma, env.D, env.action_dim) == (9, -0.1, 81, 162)
    pol = rec.make_policy(env, device=CPU)
    assert [w.shape[1] for k, w in sorted(pol.params.flat().items())
            if k.endswith("/w")] == [256, 256, 256, 256, 162 + 81 + 1]
    np.testing.assert_array_equal(
        env.init(CPU).reward_params["J"].numpy(),
        -0.1 * jising.toroidal_adjacency(9))


def test_cli_trains_ising_ebgfn_on_the_cpu(capsys):
    assert torch_run.main(["--recipe", "ising_ebgfn", "--iterations", "3",
                           "--device", "cpu", "--set", "n=3",
                           "--set", "num_data=50"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "trained ising_ebgfn for 3 iterations on cpu"
    # the recipe's eval_every (500): rows at iteration 0 and the last
    rows = [ln.split() for ln in out if ln.startswith("it ")]
    assert [int(r[1]) for r in rows] == [0, 2]
    for r in rows:
        assert r[2::2][:3] == ["gfn_loss", "-logRMSE", "mh_accept"]
        assert all(np.isfinite(float(v)) for v in r[3:8:2])
    assert torch_run.main(["--list"]) == 0
    assert any(ln.startswith("ising_ebgfn ")
               for ln in capsys.readouterr().out.splitlines())


def test_run_recipe_history_rows_are_jax_rows():
    out = torch_run.run_recipe("ising_ebgfn", iterations=4, device="cpu",
                               env={"n": 3, "num_data": 50}, eval_every=2,
                               num_envs=B, log=lambda line: None)
    assert [r["it"] for r in out["history"]] == [0, 2, 3]
    for r in out["history"]:
        assert set(r) == {"it", "gfn_loss", "neg_log_rmse", "mh_accept",
                          "wall_s"}
        assert 0 <= r["mh_accept"] <= 1 and np.isfinite(r["neg_log_rmse"])
    assert [r["step"] for r in out["rows"]] == [0, 2, 3]
    assert out["state"].step == 4 and out["loop"].captured is None
    off = torch_run.run_recipe("ising_ebgfn", iterations=2, device="cpu",
                               env={"n": 3, "num_data": 50}, eval_every=0,
                               num_envs=B, log=lambda line: None)
    assert off["history"] == [] and off["state"].step == 2


def test_cli_refuses_to_run_ising_ebgfn_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", "ising_ebgfn", "--iterations", "1",
                        "--set", "n=3", "--set", "num_data=50"])
