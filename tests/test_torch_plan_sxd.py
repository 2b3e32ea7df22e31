"""``seeds_x_data`` over two gloo ranks through the training CLI, in a
child process, against ``vmap_seeds`` in this one (the helpers of
``tests/test_torch_plan_cli.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.run import main  # noqa: E402
from test_torch_plan_cli import ARGS, _cli  # noqa: E402

torch.set_num_threads(2)


def test_cli_seeds_x_data_over_2_ranks_matches_vmap_seeds(capsys):
    """``--plan seeds_x_data --num-seeds 2 --devices 2``: every rank
    holds its half of both seeds' batches; the seed-mean rows match
    ``--plan vmap_seeds --num-seeds 2`` (here, in this process)."""
    sxd = _cli("--plan", "seeds_x_data", "--num-seeds", "2", "--devices",
               "2")
    assert main(ARGS + ["--plan", "vmap_seeds", "--num-seeds", "2"]) == 0
    vm = capsys.readouterr().out
    assert "plan: seeds_x_data over 2 device(s), mesh_shape=(2,), " \
           "num_seeds=2" in sxd
    row = re.compile(r"^it +\d+ loss +(\S+) log_z +(\S+) "
                     r"mean_log_reward +(\S+)", re.M)
    a = np.asarray(row.findall(sxd), np.float64)
    b = np.asarray(row.findall(vm), np.float64)
    assert a.shape == b.shape == (5, 3)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4)
