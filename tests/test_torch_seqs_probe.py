"""The port's uniform probes of TFBind8, QM9 and AMP and the reward
correlation over them, against the JAX package's, on JAX's replayed draws
(the sources and policies of ``tests/test_torch_seqs_evals.py``, which
holds the other sequence evaluators).

Tolerances: probe states bitwise, their log-rewards 1e-6 relative;
correlations 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.evals import sampling as jsampling  # noqa: E402
from repro_torch.evals import (RewardCorrelationEval,  # noqa: E402
                               uniform_probe_states)
from test_torch_seqs import REL, _np, _same_state  # noqa: E402
from test_torch_seqs_evals import _mc_replay, _pair, replay  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["tfbind8", "qm9", "amp"])
def test_uniform_probe_and_correlation_match_jax(name):
    """With JAX's draws replayed the port's uniform probe is JAX's, state
    for state (AMP's with the forced stop); the correlation eval over it
    agrees (8 MC samples)."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _pair(name)
    stop = tenv.stop_action if name == "amp" else None
    key = jax.random.PRNGKey(23)
    jterm, jlog_r = jax.jit(lambda k: jsampling.uniform_probe_states(
        k, jenv, jp, 16, stop_action=stop))(key)
    tterm, tlog_r = uniform_probe_states(
        0, tenv, tp, 16, stop_action=stop,
        noise=replay([0], key[None], tenv.max_steps))
    _same_state(jterm, tterm, "probe")
    np.testing.assert_allclose(tlog_r.numpy(), _np(jlog_r), rtol=1e-6)
    key, seed = jax.random.PRNGKey(8), 77
    jev = jax.jit(jsampling.RewardCorrelationEval(
        jenv, jp, jpol.apply, jterm, jlog_r, mc_samples=8))(key, jparams)
    tev = RewardCorrelationEval(
        tenv, tp, tpol, tterm, tlog_r, mc_samples=8,
        noise=_mc_replay(key, seed, 8, tenv.max_steps))(seed)
    for m in ("pearson", "spearman"):
        np.testing.assert_allclose(float(tev[m]), float(jev[m]), **REL)

