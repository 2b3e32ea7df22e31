"""The parts of the port's bitseq_tb training slice against the JAX
package's, at the sizes of ``tests/test_torch_train.py`` (bitseq n=16,
k=4, a 2-layer, dim-32, 4-head decode policy with JAX-initialised
parameters), whose fixture and helpers they share: bitseq's backward mask
and action, one exploring rollout on JAX's replayed draws, the teacher
forcing and the TB parts, the optimizer's groups and the epsilon schedule.
The training loop's iterations and the CLI stay in that file.

Tolerances: those of ``tests/test_torch_train.py``: actions and tokens
bitwise; log-probs and losses 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.objectives import evaluate_trajectory as jax_evaluate  # noqa: E402
from repro.core.objectives import tb_parts as jax_tb_parts  # noqa: E402
from repro.core.rollout import forward_rollout as jax_forward_rollout  # noqa: E402
from repro.core.trainer import GFNConfig as JaxGFNConfig  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro_torch.core.objectives import (evaluate_trajectory,  # noqa: E402
                                         objective_parts, tb_parts)
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.core.trainer import (GFNConfig, current_eps,  # noqa: E402
                                      make_optimizer)
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from test_torch_train import (B, CPU, EPS, K, N, REL, SMALL,  # noqa: E402,F401
                              _assert_batches_equal, _jax_batch_to_torch,
                              _np, _replay_rows,
                              _torch_policy, pair, replay_noise)

torch.set_num_threads(2)


def test_backward_mask_and_action_match_jax():
    jenv, tenv = JaxBitSeq(n=N, k=K), BitSeqEnvironment(n=N, k=K)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    assert tenv.backward_action_dim == jenv.backward_action_dim
    rng = np.random.RandomState(0)
    _, js = jenv.reset(5, jp)
    _, ts = tenv.reset(5, tp)
    for _ in range(jenv.L):
        mask = _np(jenv.forward_mask(js, jp))
        act = np.asarray([rng.choice(np.nonzero(r)[0]) for r in mask],
                         np.int32)
        _, jn, _, _, _ = jenv.step(js, jnp.asarray(act), jp)
        _, tn, _, _ = tenv.step(ts, torch.from_numpy(act).long(), tp)
        np.testing.assert_array_equal(
            tenv.backward_mask(tn, tp).numpy(), _np(jenv.backward_mask(jn, jp)))
        np.testing.assert_array_equal(
            tenv.get_backward_action(ts, torch.from_numpy(act).long(), tn,
                                     tp).numpy(),
            _np(jenv.get_backward_action(js, jnp.asarray(act), jn, jp)))
        js, ts = jn, tn


def test_exploring_rollout_matches_jax(pair):
    """eps = 0.5: the explore coin, the uniform draw and the categorical
    draw all come from replayed JAX noise; the batches agree field for
    field (actions bitwise)."""
    (jenv, jp, jpol, jparams, _), (tenv, tp) = pair
    key = jax.random.PRNGKey(11)
    jb = jax_forward_rollout(key, jenv, jp, jpol, jparams, B,
                             exploration_eps=jnp.float32(EPS))
    tpol = _torch_policy(jparams)
    tb = forward_rollout(0, tenv, tp, tpol, B,
                         noise=replay_noise(lambda s: key),
                         exploration_eps=EPS)
    _assert_batches_equal(tb, jb)
    # both branches ran: some rows explored (u < eps) and some did not
    T = jenv.L
    ids, ts = np.tile(np.arange(B), T), np.repeat(np.arange(T), B)
    _, _, u = _replay_rows(key, jnp.asarray(ids), jnp.asarray(ts),
                           jnp.zeros((jenv.action_dim,)))
    assert 0 < int((_np(u) < EPS).sum()) < T * B


def test_evaluate_trajectory_and_tb_parts_match_jax(pair):
    (jenv, jp, jpol, jparams, _), (tenv, tp) = pair
    jb = jax_forward_rollout(jax.random.PRNGKey(5), jenv, jp, jpol, jparams,
                             B, exploration_eps=jnp.float32(EPS))
    jev = jax_evaluate(jpol, jparams, jb)
    jnum, jden = jax_tb_parts(jev, jb, jparams["log_z"] + 0.25)
    tpol = _torch_policy(jparams)
    tb = _jax_batch_to_torch(jb)
    tev = evaluate_trajectory(tpol, tb)
    for name in ("log_pf", "log_pb", "log_flow", "log_pf_stop"):
        np.testing.assert_allclose(getattr(tev, name).detach().numpy(),
                                   _np(getattr(jev, name)), err_msg=name,
                                   **REL)
    tnum, tden = tb_parts(tev, tb, tpol.params["log_z"] + 0.25)
    np.testing.assert_allclose(float(tnum.detach()), float(jnum), rtol=1e-5)
    assert float(tden) == float(jden) == B
    # every objective of the JAX package is ported; a name outside it raises
    assert callable(objective_parts("fldb")) and callable(
        objective_parts("mdb"))
    with pytest.raises(KeyError, match="ebgfn"):
        objective_parts("ebgfn")


def test_optimizer_groups_and_eps_schedule():
    tpol = TransformerPolicy(17, 4, 64, device=CPU, requires_grad=True,
                             **SMALL)
    opt = make_optimizer(GFNConfig(), tpol.params)
    lrs = sorted(g["lr"] for g in opt.param_groups)
    assert lrs == [1e-3, 1e-1]
    assert [p for g in opt.param_groups if g["lr"] == 1e-1
            for p in g["params"]] == [tpol.params["log_z"]]
    # the clip runs as a step pre-hook; weight decay makes it AdamW
    clipped = make_optimizer(GFNConfig(max_grad_norm=1.0, weight_decay=0.1),
                             tpol.params)
    assert isinstance(clipped, torch.optim.AdamW)
    assert len(clipped._optimizer_step_pre_hooks) == 1
    cfg = GFNConfig(exploration_eps=0.3, exploration_anneal_steps=10)
    from repro.core.trainer import current_eps as jax_current_eps
    jcfg = JaxGFNConfig(exploration_eps=0.3, exploration_anneal_steps=10)
    for step in (0, 3, 7, 10, 12):
        assert current_eps(cfg, step) == float(
            jax_current_eps(jcfg, jnp.int32(step)))

