"""qwen3-moe-30b-a3b (top-k routing with capacity drops, no shared experts; the
aux loss in the objective): the loss, every gradient leaf and one train step
of its smoke config against the JAX package's, in float32 and bfloat16 (the
method and tolerances of ``test_torch_lm_train.py``, whose helpers this file
imports)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import check_arch  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ['qwen3-moe-30b-a3b'])
def test_moe3_loss_gradients_and_train_step_match_jax(arch, dtype):
    check_arch(arch, dtype)
