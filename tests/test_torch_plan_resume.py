"""A data-parallel run's checkpoints through the training CLI, in child
processes (two gloo ranks on the CPU, started by ``python -m
repro_torch.run``; the helpers of ``tests/test_torch_plan_cli.py``).
"""
import concurrent.futures

import pytest

torch = pytest.importorskip("torch")

from test_torch_plan_cli import _cli  # noqa: E402

torch.set_num_threads(2)


def test_cli_data_parallel_resume_is_the_straight_run(tmp_path):
    """Two ranks with the replay sampler, checkpointed in JAX's layout
    (each sampler leaf gathered to rank 0 with a leading shard axis, each
    rank restoring its own slice): cut at 3 and resumed to 5, every leaf
    of the final checkpoint bitwise the uninterrupted run's."""
    from repro_torch.checkpoint import CheckpointManager
    args = ["--plan", "data_parallel", "--devices", "2", "--sampler",
            "replay", "--replay-capacity", "32"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    # the straight run and the cut one side by side: two groups of two
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda extra: _cli(*args, *extra), [
            ("--checkpoint-every", "5", "--checkpoint-dir", a),
            ("--iterations", "3", "--checkpoint-every", "3",
             "--checkpoint-dir", b)]))
    _cli(*args, "--checkpoint-every", "5", "--checkpoint-dir", b,
         "--restore")
    want, got = CheckpointManager(a).load(5), CheckpointManager(b).load(5)
    assert want.keys() == got.keys()
    assert want[".sampler/.size"].tolist() == [16, 16]
    assert want[".sampler/.data/log_reward"].shape == (2, 16)
    for k in want:
        assert torch.equal(want[k], got[k]), k
