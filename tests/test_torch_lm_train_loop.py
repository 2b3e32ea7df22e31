"""The port's LM training driver (``repro_torch.launch.train``) and its
state: remat, checkpoints across the packages, the CLI.

- ``remat="full"`` (each layer under ``torch.utils.checkpoint``) gives the
  gradients of ``remat="none"`` bit for bit on the CPU, with the flash
  and scan forwards run twice a layer and their backwards once;
  ``remat="dots"`` raises when differentiated.
- A checkpoint of JAX's LM state -- ``(params, opt_state)`` written by
  ``repro.checkpoint.manager`` under the names ``repro.launch.train``
  saves -- restores bitwise into the port's state, and the port's
  ``train_loop`` resumes from it: its next step equals JAX's (float32,
  1e-4).  The reverse: the port's ``train_loop`` checkpoint restores
  bitwise into JAX's tree, and JAX's next step equals the port's resumed
  one.  (JAX's own ``train_loop`` fails under JAX 0.9 at the embedding
  gather with a ShardingTypeError, ``ROADMAP.md`` queue 3, so JAX's steps
  run its ``make_train_step`` jitted, as its loop does, without the mesh.)
- The CLI on ``--device cpu --smoke``; without a card it raises unless
  ``--device cpu`` is given; a mesh other than 1x1 is refused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa
from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            lm_train_leaves)
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from test_torch_lm_train import (CPU, close, configs, jax_state,  # noqa
                                 np32)

torch.set_num_threads(2)

ARCH, B, S, SEED = "hymba-1.5b", 2, 16, 3


def _grads(cfg, params, batch):
    leaves = steps.param_leaves(params)
    total, _ = steps.loss_fn(params, cfg, steps.LMTrainConfig(), batch)
    return torch.autograd.grad(total, list(leaves.values()),
                               materialize_grads=True)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_remat_full_equals_none_and_runs_each_forward_twice(arch,
                                                            monkeypatch):
    cfg, jcfg = configs(arch, "float32")
    jp, _ = jax_state(jcfg, jax_steps.LMTrainConfig())
    params, _ = train_state_from_jax(jax.device_get(jp), None, CPU)
    batch = tokens.synthetic_gfn_batch(cfg, B, S, seed=1, step=0, device=CPU)
    calls = {"fwd": 0, "bwd": 0}
    op_fwd, op_bwd = (("_flash_forward", "flash_attention_backward")
                      if cfg.family == "hybrid" else
                      ("_scan_forward", "rwkv6_scan_backward"))
    fwd, bwd = getattr(ops, op_fwd), getattr(ops, op_bwd)

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, op_fwd, count("fwd", fwd))
    monkeypatch.setattr(ops, op_bwd, count("bwd", bwd))
    plain = _grads(dataclasses.replace(cfg, remat="none"), params, batch)
    assert calls == {"fwd": cfg.num_layers, "bwd": cfg.num_layers}
    calls.update(fwd=0, bwd=0)
    remat = _grads(dataclasses.replace(cfg, remat="full"), params, batch)
    assert calls == {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    with pytest.raises(NotImplementedError, match="dots"):
        _grads(dataclasses.replace(cfg, remat="dots"), params, batch)
    with torch.no_grad():       # scoring ignores remat
        from repro_torch.models import lm as LM
        LM.forward_train(params["model"], dataclasses.replace(
            cfg, remat="dots"), batch)


def _jax_steps(jcfg, jp, js, step_ids):
    train_step, _ = jax_steps.make_train_step(jcfg, jax_steps.LMTrainConfig(
        lr=3e-4))
    step = jax.jit(train_step)
    for t in step_ids:
        b = jax_tokens.synthetic_gfn_batch(jcfg, B, S, seed=SEED, step=t)
        jp, js, _ = step(jp, js, b)
    return jp, js


def _port_leaves(out):
    return lm_train_leaves(out["params"], out["opt_state"])


def _assert_same(port_leaves, jax_tree, tol=1e-4):
    want = dict(_flatten(jax_tree)[0])
    assert sorted(port_leaves) == sorted(want)
    for n, t in port_leaves.items():
        w = want[n]
        if "/.nu/" in n:
            t, w = t.detach().sqrt(), np.sqrt(np32(w))
        close(t, w, tol, n)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    cfg, jcfg = configs(ARCH, "float32")
    jp, js = jax_state(jcfg, jax_steps.LMTrainConfig(lr=3e-4))
    jp, js = _jax_steps(jcfg, jp, js, [0, 1])
    JaxManager(tmp_path, process_index=0).save(2, (jp, js), blocking=True)
    # the restore is bitwise
    params, opt_state, _ = train.init_state(cfg, steps.LMTrainConfig(),
                                            seed=0, device=CPU)
    target = lm_train_leaves(params, opt_state)
    CheckpointManager(tmp_path).restore(2, target)
    for n, w in dict(_flatten((jp, js))[0]).items():
        got = target[n].detach()
        if got.dtype == torch.bfloat16:
            got = got.float()
        assert np.array_equal(got.numpy(), np.asarray(w).astype(
            got.numpy().dtype)), n
    # the port resumes at step 2 and runs it as JAX does
    out = train.train_loop(cfg, steps=3, batch=B, seq=S, seed=SEED,
                           ckpt_dir=str(tmp_path), lr=3e-4, device="cpu")
    assert [h["step"] for h in out["history"]] == [2]
    _assert_same(_port_leaves(out), _jax_steps(jcfg, jp, js, [2]))
    assert CheckpointManager(tmp_path).latest_step() == 3


def test_port_checkpoint_resumes_in_jax(tmp_path):
    cfg, jcfg = configs(ARCH, "float32")
    train.train_loop(cfg, steps=2, batch=B, seq=S, seed=SEED,
                     ckpt_dir=str(tmp_path / "a"), lr=3e-4, device="cpu")
    jp0, js0 = jax_state(jcfg, jax_steps.LMTrainConfig(lr=3e-4))
    jp, js = JaxManager(tmp_path / "a", process_index=0).restore(
        2, (jp0, js0))
    saved = CheckpointManager(tmp_path / "a").load(2)
    for n, w in dict(_flatten((jp, js))[0]).items():
        assert np.array_equal(np.asarray(w), saved[n].numpy()), n
    # JAX's next step equals the port's resumed one
    out = train.train_loop(cfg, steps=3, batch=B, seq=S, seed=SEED,
                           ckpt_dir=str(tmp_path / "a"), lr=3e-4,
                           device="cpu")
    _assert_same(_port_leaves(out), _jax_steps(jcfg, jp, js, [2]))


def test_cli_trains_a_smoke_config_on_the_cpu(tmp_path, capsys):
    train.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "2",
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
    assert CheckpointManager(tmp_path).latest_step() == 2
    names = CheckpointManager(tmp_path).load(2)
    assert {"0/log_z", "1/1/.count", "1/1/.mu/model/embed"} <= set(names)


def test_cli_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "hymba-1.5b", "--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="item 21"):
        train.main(["--arch", "hymba-1.5b", "--smoke", "--mesh", "2x2",
                    "--device", "cpu"])
