"""The training CLI's plan flags in child processes, as a user runs them:
``--plan data_parallel --devices 4 --device cpu`` starts its four ranks
(gloo on the CPU) and matches ``--plan single``; without ``--device cpu``
it refuses a machine with fewer cards than ranks (its checkpoints:
``tests/test_torch_plan_resume.py``; ``seeds_x_data`` over two ranks:
``tests/test_torch_plan_sxd.py``).  (``--plan vmap_seeds``
in this process: ``tests/test_torch_plan.py``.)  Children get their
settings as arguments and an environment of their own.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.run import main  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


ARGS = ["--recipe", "hypergrid_tb", "--iterations", "5", "--eval-every",
        "0", "--num-envs", "16", "--set", "dim=2", "--set", "side=4",
        "--device", "cpu"]


def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.run", *ARGS, *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_data_parallel_over_4_ranks_matches_single(capsys):
    """``python -m repro_torch.run --plan data_parallel --devices 4
    --device cpu`` starts its 4 ranks itself; rank 0's rows match
    ``--plan single`` (here, in this process) at JAX's tolerance, as
    printed (4 decimals)."""
    dp = _cli("--plan", "data_parallel", "--devices", "4")
    assert main(ARGS + ["--plan", "single"]) == 0
    single = capsys.readouterr().out
    assert "plan: data_parallel over 4 device(s), mesh_shape=(4,)" in dp
    row = re.compile(r"^it +\d+ loss +(\S+) log_z +(\S+) "
                     r"mean_log_reward +(\S+)", re.M)
    a = np.asarray(row.findall(dp), np.float64)
    b = np.asarray(row.findall(single), np.float64)
    assert a.shape == b.shape == (5, 3)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4)
    assert dp.count("trained hypergrid_tb for 5 iterations") == 1


def test_cli_data_parallel_refuses_missing_cards():
    """Rank r takes cuda:r: with fewer cards than ranks the CLI refuses
    unless ``--device cpu``."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.run", "--recipe", "hypergrid_tb",
         "--plan", "data_parallel", "--devices", "2"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "needs 2 CUDA devices" in out.stderr


