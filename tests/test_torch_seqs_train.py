"""The port's sequence-design recipes against the JAX package's: one
``TrainLoop`` iteration of ``tfbind8_tb``, ``qm9_tb`` and ``amp_tb`` (AMP at
max_len 10) with small policies whose JAX-initialised parameters are
carried across and JAX's noise replayed; and the CLI, ``bitseq_tb``'s
evals included.

Noise: a step-noise source that replays JAX's draws, as
``tests/test_torch_train.py`` does (iteration 0 of ``repro.algo.TrainLoop``
samples with ``k_sample = split(split(key)[1])[1]`` from the parameters
``init(split(key)[0])``; env e at step t folds ``split(k_sample, T)[t]``
with e and splits the result into ``(key_u, key_c, key_m)``).

Tolerances (fp32 on both sides, other reduction orders): actions bitwise;
loss 1e-5 relative; each gradient to 1e-4 of its tensor's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward_rollout  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs import sequences as jseq  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.recipes import get_train  # noqa: E402
from repro_torch.rewards.amp import AMPRewardModule  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = dict(num_layers=2, dim=32, num_heads=4)
B = 6
EPS = 0.5            # explore on about half the rows: both branches run
AMP_LEN = 10
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4


def _np(x):
    return np.array(x)


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


def _amp_pair(max_len=AMP_LEN):
    """JAX's AMP env at ``max_len`` and the port's, on JAX's proxy draw."""
    jenv = jseq.AMPEnvironment(max_len=max_len)
    jp = jenv.init(jax.random.PRNGKey(0))
    proxy = {k: v for k, v in jax.device_get(jp).items() if k != "r_min"}
    tenv = tseq.AMPEnvironment(AMPRewardModule(max_len=max_len, proxy=proxy),
                               max_len=max_len)
    return jenv, jp, tenv


def _case(name):
    """(jax env, jax env params, port env, policy kwargs, config kwargs)."""
    if name == "tfbind8_tb":
        jenv = jseq.TFBind8Environment()
        return (jenv, jenv.init(jax.random.PRNGKey(0)),
                tseq.TFBind8Environment(), dict(max_len=8, arch="decode"),
                dict(lr=5e-4, log_z_lr=0.05, exploration_eps=EPS))
    if name == "qm9_tb":
        jenv = jseq.QM9Environment()
        return (jenv, jenv.init(jax.random.PRNGKey(0)),
                tseq.QM9Environment(), dict(max_len=5, arch="pooled"),
                dict(lr=5e-4, log_z_lr=0.05, exploration_eps=EPS))
    jenv, jp, tenv = _amp_pair()
    return (jenv, jp, tenv,
            dict(max_len=AMP_LEN, arch="decode", init_log_z=150.0),
            dict(lr=1e-3, log_z_lr=0.64, exploration_eps=EPS,
                 stop_action=jenv.stop_action))


def _one_iteration(name):
    jenv, jp, tenv, pkw, ckw = _case(name)
    jpol = make_transformer_policy(jenv.vocab_size, pkw["max_len"],
                                   jenv.action_dim, jenv.backward_action_dim,
                                   arch=pkw["arch"],
                                   init_log_z=pkw.get("init_log_z", 0.0),
                                   **SMALL)
    key = jax.random.PRNGKey(7)
    jcfg = JaxGFNConfig(objective="tb", num_envs=B, **ckw)
    # iteration 0 of repro.algo.TrainLoop.run(key): params from split(key)
    # [0], the rollout keyed k_sample at epsilon(0), then the loss parts
    jparams0 = jpol.init(jax.random.split(key)[0])
    k_sample = jax.random.split(jax.random.split(key)[1])[1]
    jb = jax_forward_rollout(k_sample, jenv, jp, jpol, jparams0, B,
                             exploration_eps=jnp.float32(EPS))
    (jnum, jden), jgrads = jax.jit(jax.value_and_grad(
        jax_parts_fn(jenv, jpol, jcfg), has_aux=True))(jparams0, jb)
    jden = jnp.maximum(jden, 1.0)
    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda g: _np(g / jden), jgrads))
    jr = {"batch": jax.tree_util.tree_map(_np, jb),
          "loss": float(jnum / jden)}

    tpol = TransformerPolicy(tenv.vocab_size, action_dim=tenv.action_dim,
                             device=CPU, requires_grad=True, **pkw, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams0)))
    loop = TrainLoop(tenv, tenv.init(CPU), tpol,
                     GFNConfig(objective="tb", num_envs=B, **ckw),
                     sampler=OnPolicySampler(
                         noise=replay_step_noise(k_sample, tenv.max_steps)))
    state = loop.init(seed=0)
    batch = loop.sample(state)
    loss = float(loop.loss_and_grads(batch))
    grads = {n: p.grad.clone() for n, p in tpol.params.flat().items()}
    return jr, batch, loss, grads, jgrads


@pytest.fixture(scope="module", params=["tfbind8_tb", "qm9_tb", "amp_tb"])
def one_iteration(request):
    return request.param, _one_iteration(request.param)


def test_batch_and_loss_match_jax(one_iteration):
    name, (jr, tb, loss, _, _) = one_iteration
    jb = jr["batch"]
    for field in ("obs", "fwd_mask", "bwd_mask", "actions", "bwd_actions",
                  "valid", "done"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      getattr(jb, field),
                                      err_msg=f"{name} {field}")
    np.testing.assert_allclose(tb.log_reward.numpy(), jb.log_reward,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.log_pf_beh.numpy(), jb.log_pf_beh,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, jr["loss"], rtol=1e-5,
                               err_msg=name)
    if name == "amp_tb":
        # rows stopped at different steps: the cache's lengths were ragged
        stop_steps = (tb.actions == tb.fwd_mask.shape[-1] - 1).float(
            ).argmax(0)
        assert len(set(stop_steps.tolist())) > 1


def test_gradients_match_jax(one_iteration):
    """Every parameter's gradient of one iteration; for qm9_tb they come
    through the pooled encoder and the traj_logprob backward's plain
    version."""
    name, (_, _, _, grads, jgrads) = one_iteration
    assert set(grads) == set(jgrads)
    for pname, g in jgrads.items():
        g = g.numpy()
        np.testing.assert_allclose(grads[pname].numpy(), g,
                                   err_msg=f"{name} {pname}", rtol=0,
                                   atol=GRAD_ATOL * np.abs(g).max())


# -- the CLI -------------------------------------------------------------------

def test_bitseq_tb_runs_its_evals():
    """The refusal of bitseq_tb's evals is gone: eval rows at every
    iteration, the correlations in [-1, 1], the bounds finite."""
    lines = []
    out = torch_run.run_recipe("bitseq_tb", iterations=2, eval_every=1,
                               num_envs=4, env={"n": 16, "k": 4},
                               device="cpu", log=lines.append)
    rows = out["rows"]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"step", "pearson", "spearman", "elbo",
                          "log_z_is"}
        assert all(np.isfinite(v) for v in r.values())
        assert -1 <= r["pearson"] <= 1 and -1 <= r["spearman"] <= 1
    assert get_train("bitseq_tb").eval_every == 1000


@pytest.mark.parametrize("recipe,sets,metrics", [
    ("tfbind8_tb", [], {"sample_tv", "sample_jsd", "mode_hits", "pearson",
                        "spearman", "elbo", "log_z_is"}),
    ("qm9_tb", [], {"sample_tv", "sample_jsd", "mode_hits", "pearson",
                    "spearman", "elbo", "log_z_is"}),
    ("amp_tb", ["--set", f"max_len={AMP_LEN}"],
     {"pearson", "spearman", "elbo", "log_z_is"}),
])
def test_cli_trains_with_evals_on_the_cpu(capsys, recipe, sets, metrics):
    assert torch_run.main(["--recipe", recipe, "--iterations", "2",
                           "--device", "cpu", "--num-envs", "4",
                           "--eval-every", "1", "--eval-batch", "64",
                           *sets]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("it ")]) == 2
    evals = [ln.split() for ln in out if ln.startswith("eval it ")]
    assert [int(e[2]) for e in evals] == [0, 1]
    for e in evals:
        got = dict(zip(e[3::2], map(float, e[4::2])))
        assert set(got) == metrics
        assert all(np.isfinite(v) for v in got.values())
    assert "on cpu" in out[-1]


@pytest.mark.parametrize("recipe", ["tfbind8_tb", "qm9_tb", "amp_tb"])
def test_cli_refuses_to_run_without_cuda(recipe):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--recipe", recipe, "--iterations", "1"])
