"""The port's ``data_parallel`` over 4 gloo ranks against JAX's
``DataParallelPlan`` over 4 of the conftest's virtual devices: the cases,
draws and tolerances of ``tests/test_torch_plan_dp.py`` (2 ranks), whose
helpers run them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_plan_dp import held_against_jax  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4,
    reason="needs 4 (virtual) devices; conftest forces 8 unless XLA_FLAGS "
           "was preset")


@pytest.mark.parametrize("replay", [False, True])
def test_data_parallel_matches_jax_data_parallel(replay, tmp_path):
    held_against_jax(4, replay, tmp_path)
