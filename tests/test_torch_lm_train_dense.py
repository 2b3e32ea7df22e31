"""The dense family's larger configs (qwen2-72b, command-r-plus-104b): the
loss, every gradient leaf and one train step of each smoke config against
the JAX package's, in float32 and bfloat16 (the method and tolerances of
``test_torch_lm_train.py``, whose helpers this file imports)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import check_arch  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ['qwen2-72b', 'command-r-plus-104b'])
def test_dense_loss_gradients_and_train_step_match_jax(arch, dtype):
    check_arch(arch, dtype)
