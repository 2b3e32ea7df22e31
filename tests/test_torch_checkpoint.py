"""Checkpoints move between the packages (the port's
``repro_torch.checkpoint`` against ``repro.checkpoint.manager``).

- The leaf names the port writes are ``repro.checkpoint.manager._flatten``'s
  of a real JAX ``LoopState`` (2x6 ``hypergrid_tb`` with the replay sampler,
  a clip, weight decay and evals), ``.train/.key`` aside.
- The port restores that JAX checkpoint bitwise: params, Adam's moments,
  count and step, the replay buffer and the eval rows.
- From a JAX checkpoint of the on-policy recipe (no clip: Adam at tuple
  index 0), one further port iteration on JAX's replayed noise equals
  JAX's next iteration: parameters within 1e-3 of the group's lr
  absolute and 1e-5 relative (fp32; gradients reduce in another order).
- JAX's ``restore_subtree`` (its serving loader) reads a port checkpoint's
  policy params bitwise; JAX's full ``restore`` refuses it, missing
  ``.train/.key``.  A bfloat16 leaf crosses both ways bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import recipes as jax_recipes  # noqa: E402
from repro.algo.loop import LoopState  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.core.types import TrainState  # noqa: E402
from repro.run import run_recipe as jax_run_recipe  # noqa: E402
from repro_torch.algo import OnPolicySampler, TrainLoop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.recipes import get_train  # noqa: E402
from repro_torch.run import run_recipe  # noqa: E402

from test_torch_hypergrid_train import replay_step_noise  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = {"dim": 2, "side": 6}
CFG = {"max_grad_norm": 1.0, "weight_decay": 1e-4}
REPLAY = dict(sampler="replay", sampler_kwargs={"capacity": 64})


def _quiet(_):
    pass


def _jax_leaves(state):
    return {n: np.array(v) for n, v in _flatten(state)[0]}


@pytest.fixture(scope="module")
def jax_replay_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_replay")
    out = jax_run_recipe("hypergrid_tb", iterations=3, eval_every=2,
                         env=GRID, config=CFG, checkpoint_dir=str(d),
                         checkpoint_every=3, log=_quiet, **REPLAY)
    return d, out


def test_port_names_are_jax_flattened_names(jax_replay_run):
    d, jout = jax_replay_run
    out = run_recipe("hypergrid_tb", iterations=3, eval_every=2, env=GRID,
                     config=CFG, device="cpu", checkpoint_dir=str(d),
                     restore=True, log=_quiet, **REPLAY)
    assert not out["history"]           # step 3 of 3: nothing left to run
    loop, state = out["loop"], out["state"]
    tree = loop.checkpoint_tree(state, out["suite"], 3)
    jleaves = _jax_leaves(jout["state"])
    assert set(tree) == set(jleaves) - {".train/.key"}
    # the restore is bitwise, every leaf at JAX's dtype in the tree
    for name, t in tree.items():
        want = jleaves[name]
        got = t.detach().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(state.counter) == 3 and out["rows"] == jout["metrics"]


@pytest.fixture(scope="module")
def jax_on_policy_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_on_policy")
    first = jax_run_recipe("hypergrid_tb", iterations=3, eval_every=0,
                           env=GRID, checkpoint_dir=str(d),
                           checkpoint_every=3, log=_quiet)
    keys = _jax_leaves(first["state"])
    second = jax_run_recipe("hypergrid_tb", iterations=4, eval_every=0,
                            env=GRID, checkpoint_dir=str(d), restore=True,
                            log=_quiet)
    return d, keys, _jax_leaves(second["state"])


def test_jax_checkpoint_resumes_in_the_port(jax_on_policy_runs):
    d, at3, at4 = jax_on_policy_runs
    rec = get_train("hypergrid_tb")
    env = rec.make_env(**GRID)
    env_params = env.init(CPU)
    policy = rec.make_policy(env, seed=0, device=CPU, requires_grad=True)
    # JAX's step 4 keys its batch on split(key_3)[1] (repro/algo/loop.py)
    k_sample = jax.random.split(jnp.asarray(at3[".train/.key"]))[1]
    loop = TrainLoop(env, env_params, policy,
                     rec.make_config(env, rec.num_envs, 4),
                     sampler=OnPolicySampler(noise=replay_step_noise(
                         lambda s: k_sample, env.max_steps)))
    state = loop.init(seed=0)
    assert loop.restore_state(state, CheckpointManager(d), 3) == 3
    tree = loop.checkpoint_tree(state)
    assert set(tree) == set(at3) - {".train/.key"}
    assert all(n.startswith((".train/.params", ".train/.opt_state/0/",
                             ".train/.step")) for n in tree)
    for name, t in tree.items():
        np.testing.assert_array_equal(t.detach().numpy(), at3[name],
                                      err_msg=name)
    loop.iteration(state)
    assert int(state.counter) == 4
    for name, p in state.params.flat().items():
        lr = 1e-1 if name == "log_z" else 1e-3
        np.testing.assert_allclose(
            p.detach().numpy(), at4[f".train/.params/{name}"], rtol=1e-5,
            atol=1e-3 * lr, err_msg=name)
    st = loop._adam_state(state.optimizer, policy.params["log_z"])
    assert float(st["step"]) == int(at4[".train/.opt_state/0/.count"]) == 4


def test_jax_serving_loader_reads_port_checkpoint(tmp_path):
    out = run_recipe("hypergrid_tb", iterations=2, eval_every=0, env=GRID,
                     config=CFG, device="cpu", checkpoint_dir=str(tmp_path),
                     checkpoint_every=1, log=_quiet, **REPLAY)
    jrec = jax_recipes.get("hypergrid_tb")
    jenv = jrec.make_env(**GRID)
    template = jrec.make_policy(jenv).init(jax.random.PRNGKey(5))
    jm = JaxManager(tmp_path)
    assert jm.all_steps() == [1, 2] and jm.latest_step() == 2
    got = {n: np.array(v)
           for n, v in _flatten(jm.restore_subtree(2, template))[0]}
    want = {n: p.detach().numpy() for n, p in
            out["state"].params.flat().items()}
    assert set(got) == set(want)
    for n in want:
        assert got[n].tobytes() == want[n].tobytes(), n
    # the port writes no threefry key, so JAX's full restore refuses
    target = LoopState(train=TrainState(params=template, opt_state=(),
                                        step=jnp.int32(0),
                                        key=jax.random.PRNGKey(0)),
                       sampler=())
    with pytest.raises(ValueError, match=r"'\.train/\.key'"):
        jm.restore(2, target)


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 3).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    CheckpointManager(tmp_path / "port").save(1, {"w": t, "n": torch.ones(2)})
    got = JaxManager(tmp_path / "port")._load_arrays(1)
    assert got["w"].dtype == ml_dtypes.bfloat16
    assert got["w"].tobytes() == t.view(torch.int16).numpy().tobytes()
    JaxManager(tmp_path / "jax").save(
        1, {"w": jnp.asarray(x, jnp.bfloat16)})
    back = CheckpointManager(tmp_path / "jax").load(1)["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
