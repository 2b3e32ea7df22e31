"""The port's checkpoints within the port: resumes, the manager's rules and
serving from a checkpoint.

- A run interrupted at a checkpoint and resumed with ``restore=True`` is
  bitwise the uninterrupted run: every leaf of the state (params, Adam's
  moments and step, the counter, the replay buffer) and the eval rows.
  On the 2x6 hypergrid with the replay sampler, a time limit, a scheduled
  beta, a clip and weight decay (the anneal pinned with ``exploration_
  anneal_steps``: the recipe's follows the iteration budget), and
  ``hypergrid_subtb`` on the 3x4 grid with the backward-replay sampler.
  (The transformer recipes' CPU backward is not bitwise from run to run
  here, so ``tfbind8_tb``'s resume is held on the card, by
  ``chip_smoke.py``'s ``cli`` phase.)
- A leftover ``step_<N>.tmp`` is ignored; ``keep=3`` holds; a restore
  under another configuration raises.
- Serving from a port checkpoint equals ``forward_rollout`` under the
  restored params, token for token (bitseq n=16, k=4).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import recipes  # noqa: E402
from repro_torch.algo import TrainLoop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.run import run_recipe  # noqa: E402
from repro_torch.serve import BadRequest, SampleRequest, Scheduler  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")

CASES = {
    "hypergrid_replay": dict(
        env_name="hypergrid", env={"dim": 2, "side": 6},
        transforms=("time_limit:limit=8",
                    "reward_exponent:beta=1.0,final_beta=2.0,anneal_steps=4"),
        config={"max_grad_norm": 1.0, "weight_decay": 1e-4,
                "exploration_anneal_steps": 3},
        eval_every=2, sampler="replay",
        sampler_kwargs={"capacity": 64, "prioritized": True}),
    "hypergrid_backward_replay": dict(
        name="hypergrid_subtb", env={"dim": 3, "side": 4},
        config={"exploration_anneal_steps": 3}, eval_every=0,
        sampler="backward_replay", sampler_kwargs={"capacity": 32}),
}


def _quiet(_):
    pass


def _run(tmp_path, case, iterations, **kw):
    return run_recipe(iterations=iterations, device="cpu",
                      checkpoint_dir=str(tmp_path), log=_quiet,
                      **CASES[case], **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, case):
    whole = _run(tmp_path / "whole", case, 6, checkpoint_every=3)
    _run(tmp_path / "cut", case, 3, checkpoint_every=3)
    resumed = _run(tmp_path / "cut", case, 6, checkpoint_every=3,
                   restore=True)
    assert [r["it"] for r in resumed["history"]] == [3, 4, 5]
    a = whole["loop"].checkpoint_tree(whole["state"], whole["suite"], 6)
    b = resumed["loop"].checkpoint_tree(resumed["state"], resumed["suite"],
                                        6)
    assert set(a) == set(b)
    assert ".sampler/.data/log_reward" in a
    for name in a:
        assert torch.equal(a[name], b[name]) or (
            a[name].is_floating_point() and
            torch.equal(a[name].isnan(), b[name].isnan()) and
            torch.equal(a[name].nan_to_num(), b[name].nan_to_num())), name
    assert whole["rows"] == resumed["rows"]
    for x, y in zip(whole["history"][3:], resumed["history"]):
        assert {k: v for k, v in x.items() if k != "wall_s"} == \
            {k: v for k, v in y.items() if k != "wall_s"}
    # both directories hold the final step and the cut one
    assert CheckpointManager(tmp_path / "whole").all_steps() == [3, 6]
    assert CheckpointManager(tmp_path / "cut").all_steps() == [3, 6]


def test_manager_ignores_tmp_and_keeps_three(tmp_path):
    m = CheckpointManager(tmp_path)
    for step in range(1, 6):
        m.save(step, {".a": torch.full((2,), float(step))},
               blocking=step % 2 == 0)
    m.wait()
    assert m.all_steps() == [3, 4, 5]
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "MANIFEST.json").write_text("{}")
    (tmp_path / "step_8").mkdir()                  # no manifest: partial
    assert m.latest_step() == 5
    assert m.newer_than(None) == 5 and m.newer_than(4) == 5 \
        and m.newer_than(5) is None
    target = {".a": torch.zeros(2)}
    assert m.restore_latest(target)[0] == 5
    assert torch.equal(target[".a"], torch.full((2,), 5.0))
    doc = json.loads((tmp_path / "step_5" / "MANIFEST.json").read_text())
    assert doc == {"step": 5, "arrays": {".a": {"shape": [2],
                                                "dtype": "float32"}}}
    with pytest.raises(ValueError, match="no entry"):
        m.restore(5, {".b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        m.restore(5, {".a": torch.zeros(3)})


def test_restore_under_another_configuration_raises(tmp_path):
    kw = dict(env_name="hypergrid", env={"dim": 2, "side": 4},
              eval_every=0, device="cpu", checkpoint_dir=str(tmp_path),
              log=_quiet, sampler="replay")
    run_recipe(iterations=2, checkpoint_every=2,
               sampler_kwargs={"capacity": 32}, **kw)
    with pytest.raises(ValueError, match="sampler state does not match"):
        run_recipe(iterations=4, restore=True,
                   sampler_kwargs={"capacity": 64}, **kw)
    with pytest.raises(ValueError, match="no entry"):
        run_recipe(iterations=4, restore=True, config={"max_grad_norm": 1.},
                   sampler_kwargs={"capacity": 32}, **kw)
    rec = recipes.get_train("hypergrid_tb")
    env = rec.make_env(dim=2, side=4)
    loop = TrainLoop(env, env.init(CPU),
                     rec.make_policy(env, device=CPU, requires_grad=True),
                     rec.make_config(env, 4, 2))
    with pytest.raises(ValueError, match="need a checkpoint manager"):
        loop.run(0, 2, restore=True)


@pytest.fixture(scope="module")
def bitseq_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("bitseq_tb")
    out = run_recipe("bitseq_tb", iterations=2, env={"n": 16, "k": 4},
                     eval_every=0, device="cpu", checkpoint_dir=str(d),
                     checkpoint_every=1, log=_quiet)
    return d, out


def test_serving_from_a_checkpoint_equals_forward_rollout(bitseq_checkpoint):
    d, out = bitseq_checkpoint
    sched = Scheduler(num_lanes=3, device="cpu")
    base = dict(env="bitseq", overrides={"n": 16, "k": 4}, checkpoint=str(d))
    r0 = sched.submit(SampleRequest(num_samples=5, seed=21, **base))
    r1 = sched.submit(SampleRequest(num_samples=4, seed=22, step=1, **base))
    fresh = sched.submit(SampleRequest(env="bitseq", num_samples=5, seed=21,
                                       overrides={"n": 16, "k": 4}))
    assert sched.num_engines == 3          # latest, step 1, no checkpoint
    got = sched.run()
    rec = recipes.get("bitseq")
    env = rec.make_env(n=16, k=4)
    env_params = env.init(CPU)
    trained = out["policy"]
    ref = forward_rollout(21, env, env_params, trained, 5)
    np.testing.assert_array_equal(got[r0].samples, ref.obs[-1].numpy())
    np.testing.assert_array_equal(got[r0].log_rewards,
                                  ref.log_reward.numpy())
    # step 1's params differ from the final ones, and so do the samples
    # of the fresh policy
    step1 = rec.make_policy(env, device=CPU)
    CheckpointManager(d).restore_subtree(1, step1.params.flat())
    ref1 = forward_rollout(22, env, env_params, step1, 4)
    np.testing.assert_array_equal(got[r1].samples, ref1.obs[-1].numpy())
    assert not all(torch.equal(a, b) for a, b in zip(
        step1.params.parameters(), trained.params.parameters()))
    assert got[fresh].samples != got[r0].samples
    with pytest.raises(BadRequest, match="no complete checkpoint"):
        Scheduler(device="cpu").submit(SampleRequest(
            env="bitseq", overrides={"n": 16, "k": 4},
            checkpoint=str(d / "empty")))


def test_launch_serve_reads_a_checkpoint(bitseq_checkpoint, capsys):
    d, out = bitseq_checkpoint
    rc = serve_cli.main(["--env", "bitseq", "--smoke", "--device", "cpu",
                         "--num-samples", "3", "--seed", "7", "--lanes", "2",
                         "--checkpoint", str(d), "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    rec = recipes.get("bitseq")
    env = rec.make_env(n=16, k=4)
    ref = forward_rollout(7, env, env.init(CPU), out["policy"], 3)
    np.testing.assert_array_equal(np.array(doc["samples"]),
                                  ref.obs[-1].numpy())
