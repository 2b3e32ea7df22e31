"""The port's replay samplers on a sequence env and in the training loop,
against the JAX package's: the samplers' batches and buffers on tfbind8
with a small decode-arch transformer (whose cached forward rollout and,
for ``backward_replay``, whose learned P_B, which it has no head for, so
uniform); three ``TrainLoop`` iterations of prioritized replay on the 2x4
hypergrid against JAX's ``make_sampler_train_step`` (the loss each
iteration, every gradient of the first, the buffer carried across
iterations); and the CLI's ``--sampler`` flags, the README's replay
command among them.

Noise: the replaying sources of ``tests/test_torch_samplers.py``; the
loop's iteration i is keyed ``k_sample_i`` from JAX's key chain
(``key_{i+1}, k_sample_i = split(key_i)``).

Tolerances (fp32 on both sides): actions, masks and the buffer's states
bitwise; log-rewards 1e-6 relative; losses 1e-5 relative; each gradient
to 1e-4 of its tensor's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.algo import TrainLoop as JaxTrainLoop  # noqa: E402
from repro.algo import samplers as jsamplers  # noqa: E402
from repro.core.policies import make_mlp_policy  # noqa: E402
from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.core.trainer import make_loss_parts_fn as jax_parts_fn  # noqa: E402
from repro.envs import sequences as jseq  # noqa: E402
from repro.envs.hypergrid import HypergridEnvironment as JaxHypergrid  # noqa: E402
from repro.rewards.hypergrid import HypergridRewardModule as JaxReward  # noqa: E402
from repro_torch import run as torch_run  # noqa: E402
from repro_torch.algo import TrainLoop  # noqa: E402
from repro_torch.algo import samplers as tsamplers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import MLPPolicy, TransformerPolicy  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.envs import sequences as tseq  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402
from test_torch_samplers import (KEY_OF, assert_batch_matches,  # noqa: E402
                                 assert_buffer_matches, replay_sources,
                                 replay_step_noise, run_pair)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = dict(num_layers=2, dim=32, num_heads=4)
B, R, CAP = 4, 3, 6
ITERS = 3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4


def _np(x):
    return np.array(x)


# -- tfbind8 with a decode-arch transformer -----------------------------------

@pytest.fixture(scope="module")
def tfbind8():
    jenv = jseq.TFBind8Environment()
    jpol = make_transformer_policy(jenv.vocab_size, 8, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **SMALL)
    jparams = jpol.init(jax.random.PRNGKey(4))
    tenv = tseq.TFBind8Environment()
    tpol = TransformerPolicy(tenv.vocab_size, max_len=8,
                             action_dim=tenv.action_dim, arch="decode",
                             device=CPU, **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jenv.init(jax.random.PRNGKey(0)), jpol, jparams, tenv,
            tenv.init(CPU), tpol)


@pytest.mark.parametrize("name,kw", [
    ("eps_noisy", dict(eps=0.4)),
    ("replay", dict(capacity=CAP, replay_batch=R)),
    ("backward_replay", dict(capacity=CAP, replay_batch=R, prioritized=True,
                             temperature=0.5))])
def test_tfbind8_batches_match_jax(tfbind8, name, kw):
    jenv, jp, jpol, jparams, tenv, tp, tpol = tfbind8
    ckw = dict(objective="tb", num_envs=B, exploration_eps=0.3)
    T = tenv.max_steps
    sources = (replay_sources(KEY_OF, T) if "replay" in name
               else dict(noise=replay_step_noise(KEY_OF, T)))
    rows = run_pair(jsamplers.make_sampler(name, **kw),
                    tsamplers.make_sampler(name, **kw, **sources),
                    jenv, jp, jpol, jparams, tenv, tp, tpol,
                    JaxGFNConfig(**ckw), GFNConfig(**ckw))
    for i, (jb, jstate, tb, tbuf) in enumerate(rows):
        assert_batch_matches(tb, jb, f"{name} it {i}")
        if tbuf is not None:
            assert_buffer_matches(tbuf, jstate, f"{name} it {i}")


def test_backward_replay_on_a_decode_policy_evaluates_no_policy(tfbind8):
    """The transformer has no backward head, so the replay's learned P_B
    is the uniform one: the replay runs no policy pass (no apply, no cache
    fill, no query), only the fresh rollout's cached steps."""
    _, _, _, _, tenv, tp, tpol = tfbind8
    calls = []
    spied = {}
    for fn in ("apply", "apply_cached", "cache_fill", "query_cached"):
        real = getattr(tpol, fn)
        spied[fn] = real

        def spy(*a, _fn=fn, _real=real, **k):
            calls.append(_fn)
            return _real(*a, **k)
        setattr(tpol, fn, spy)
    try:
        s = tsamplers.make_sampler("backward_replay", capacity=CAP,
                                   replay_batch=R)
        init, sample = s.build(tenv, tp, tpol,
                               GFNConfig(num_envs=B, exploration_eps=0.3))
        st, batch = sample(init(), torch.tensor(7), torch.tensor(0))
    finally:
        for fn in spied:
            delattr(tpol, fn)
    assert calls == ["apply_cached"] * tenv.max_steps
    assert batch.actions.shape == (tenv.max_steps, B + R)


# -- three TrainLoop iterations of prioritized replay ------------------------------

def _loop_pair():
    dim, side = 2, 4
    jenv = JaxHypergrid(JaxReward(), dim=dim, side=side)
    jpol = make_mlp_policy(jenv.obs_dim, jenv.action_dim,
                           jenv.backward_action_dim, hidden=(16, 16))
    ckw = dict(objective="tb", num_envs=B, lr=1e-3, log_z_lr=1e-1,
               stop_action=dim, exploration_eps=0.3,
               exploration_anneal_steps=4)
    skw = dict(capacity=CAP, replay_batch=R, prioritized=True,
               temperature=0.7)
    jloop = JaxTrainLoop(jenv, jenv.init(jax.random.PRNGKey(0)), jpol,
                         JaxGFNConfig(**ckw),
                         sampler=jsamplers.ReplaySampler(**skw))
    jstate = jloop.init(jax.random.PRNGKey(3))
    jparams0 = jstate.train.params
    k_samples, k = [], jstate.train.key
    for _ in range(ITERS):
        k, ks = jax.random.split(k)
        k_samples.append(ks)
    step = jax.jit(jloop.step_fn)
    jrows = []
    for _ in range(ITERS):
        jstate, (metrics, jb) = step(jstate)
        jrows.append((float(metrics["loss"]), jax.tree_util.tree_map(_np, jb),
                      jax.tree_util.tree_map(_np, jstate.sampler)))
    (_, jden), jgrads = jax.jit(jax.value_and_grad(
        jax_parts_fn(jenv, jpol, JaxGFNConfig(**ckw)), has_aux=True))(
        jparams0, jax.tree_util.tree_map(jnp.asarray, jrows[0][1]))
    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda g: _np(g / jnp.maximum(jden, 1.0)), jgrads))

    tenv = HypergridEnvironment(HypergridRewardModule(), dim=dim, side=side)
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=(16, 16), device=CPU, requires_grad=True)
    tpol.load_params(params_from_jax(jax.device_get(jparams0)))
    loop = TrainLoop(tenv, tenv.init(CPU), tpol, GFNConfig(**ckw),
                     sampler=tsamplers.ReplaySampler(
                         **skw, **replay_sources(lambda i: k_samples[i],
                                                 tenv.max_steps)))
    state = loop.init(seed=0)
    trows = []
    for _ in range(ITERS):
        metrics, batch = loop.iteration(state)
        trows.append((float(metrics["loss"]), batch,
                      ({k: v.clone() for k, v in state.sampler.data.items()},
                       int(state.sampler.insert_pos),
                       int(state.sampler.size)),
                      {n: p.grad.clone()
                       for n, p in tpol.params.flat().items()}))
    return jrows, trows, jgrads, loop


@pytest.fixture(scope="module")
def loop_pair():
    return _loop_pair()


def test_replay_loop_batches_losses_and_buffer_match_jax(loop_pair):
    jrows, trows, _, loop = loop_pair
    assert loop.num_envs == B + R
    for i, ((jloss, jb, jbuf), (tloss, tb, tbuf, _)) in enumerate(
            zip(jrows, trows)):
        assert_batch_matches(tb, jb, f"it {i}")
        assert_buffer_matches(tbuf, jbuf, f"it {i}")
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5,
                                   err_msg=f"it {i}")
    # three iterations of 4 pushed 12 items through 6 slots
    assert trows[-1][2][2] == CAP and trows[-1][2][1] == (ITERS * B) % CAP


def test_replay_loop_gradients_match_jax(loop_pair):
    _, trows, jgrads, _ = loop_pair
    grads = trows[0][3]
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        g = g.numpy()
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(g).max(),
                                   err_msg=name)


def test_scan_mode_logs_every_row_of_the_replay_batch():
    """``mode="scan"`` sizes its log-reward rows to the batch the sampler
    draws (fresh and replayed rows), as JAX's scan returns them."""
    tenv = HypergridEnvironment(HypergridRewardModule(), dim=2, side=4)
    tpol = MLPPolicy(tenv.obs_dim, tenv.action_dim, tenv.backward_action_dim,
                     hidden=(16, 16), device=CPU, requires_grad=True)
    loop = TrainLoop(tenv, tenv.init(CPU), tpol,
                     GFNConfig(num_envs=B, stop_action=2),
                     sampler="replay")
    _, (metrics, log_r) = loop.run(0, 2, mode="scan")
    assert log_r.shape == (2, 2 * B)
    assert torch.isfinite(metrics["loss"]).all()


# -- the CLI ---------------------------------------------------------------------

def test_cli_replay_runs(capsys):
    assert torch_run.main(["--recipe", "hypergrid_tb", "--sampler", "replay",
                           "--prioritized", "--device", "cpu",
                           "--iterations", "3", "--eval-every", "0",
                           "--replay-capacity", "64", "--replay-batch", "5",
                           "--set", "dim=2", "--set", "side=4"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("it ")]
    assert len(rows) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in rows)


def test_cli_replay_command_at_full_size(capsys):
    """``python -m repro_torch.run --recipe hypergrid_tb --sampler replay
    --prioritized --device cpu --iterations 3``: the recipe at full size
    (4x8^4, 16 envs, a 2,048-slot buffer), three rows and the evals of
    iteration 0."""
    assert torch_run.main(["--recipe", "hypergrid_tb", "--sampler", "replay",
                           "--prioritized", "--device", "cpu",
                           "--iterations", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("it ")]
    evals = [ln for ln in out if ln.startswith("eval it")]
    assert len(rows) == 3 and len(evals) == 1
    assert all(np.isfinite(float(ln.split()[3])) for ln in rows)
    assert "exact_tv" in evals[0]


def test_run_recipe_wires_the_sampler_flags():
    out = torch_run.run_recipe(
        "tfbind8_tb", iterations=2, device="cpu", eval_every=0,
        sampler="backward_replay",
        sampler_kwargs={"capacity": 40, "replay_batch": 7,
                        "prioritized": True, "temperature": 2.0},
        log=lambda line: None)
    s = out["loop"].sampler
    assert isinstance(s, tsamplers.BackwardReplaySampler)
    assert (s.capacity, s.replay_batch, s.prioritized, s.temperature) \
        == (40, 7, True, 2.0)
    assert out["loop"].num_envs == 16 + 7
    assert int(out["state"].sampler.size) == 2 * 16
    with pytest.raises(ValueError, match="--sampler is not supported"):
        torch_run.run_recipe("ising_ebgfn", iterations=1, device="cpu",
                             sampler="replay", env={"n": 3, "num_data": 5})
