"""The port's log Z bounds and sampled-distribution eval against the JAX
package's (noise replayed from JAX's draws), and the hypergrid recipe's
tied mode set.

Tolerances: log-probabilities and bounds 1e-5 relative; the sampled TV and
JSD 1e-5 absolute; mode hits exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.evals.bounds import LogZBoundsEval as JaxBounds  # noqa: E402
from repro.evals.sampling import SampledDistributionEval as JaxSampled  # noqa: E402
from repro.recipes.hypergrid import _index_fn as jax_index_fn  # noqa: E402
from repro_torch.evals import (LogZBoundsEval,  # noqa: E402
                               SampledDistributionEval)
from repro_torch.recipes.hypergrid import (hypergrid_evals,  # noqa: E402
                                           terminal_index_fn)
from test_torch_evals import (REL, _np, _probe, _setup,  # noqa: E402
                              replay_gumbel)

torch.set_num_threads(2)


def test_log_z_bounds_match_jax():
    """ELBO and log_z_is from a forward rollout, EUBO from backward
    rollouts over a probe handed in; JAX's eval key is split into its
    forward and backward keys, whose draws the port replays."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(2, 5)
    js, ts = _probe(tenv, jenv, 24, seed=4)
    key = jax.random.PRNGKey(21)
    want = JaxBounds(jenv, jp, jpol.apply, num_samples=32, target_states=js,
                     target_log_r=jenv.log_reward(js, jp))(key, jparams)
    k_fwd, k_bwd = jax.random.split(key)
    ev = LogZBoundsEval(tenv, tp, tpol, num_samples=32, target_states=ts,
                        target_log_r=tenv.log_reward(ts, tp),
                        noise=replay_gumbel(k_fwd, tenv.max_steps),
                        backward_noise=replay_gumbel(k_bwd, tenv.max_steps))
    got = ev(0)
    assert set(got) == set(ev.metric_names) == {"elbo", "log_z_is", "eubo"}
    for name in ev.metric_names:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   err_msg=name, **REL)


def test_sampled_eval_and_tied_modes_match_jax():
    """The recipe's modes on the 4x8^4 target (4,096 states, exact ties in
    every reward band) are JAX's ``argsort(-true)[:64]``, and the sampled
    TV/JSD and mode hits of a replayed rollout equal JAX's."""
    (jenv, jp, jpol, jparams), (tenv, tp, tpol) = _setup(4, 8)
    jtrue = jenv.true_distribution(jp)
    jmodes = jnp.argsort(-jtrue)[:64]
    evals = hypergrid_evals(tenv, tp, tpol, seed=0, eval_batch=48)
    sampled = next(e for e in evals
                   if isinstance(e, SampledDistributionEval))
    np.testing.assert_array_equal(sampled.mode_indices.numpy(), _np(jmodes))
    # ties are real: the 64 modes share one reward value with other states
    true = tenv.true_distribution(tp)
    assert int((true == true[sampled.mode_indices[-1]]).sum()) > 64
    key = jax.random.PRNGKey(6)
    want = JaxSampled(jenv, jp, jpol.apply, jax_index_fn(jenv),
                      tenv.num_terminal_states, true_dist=jtrue,
                      mode_indices=jmodes, num_samples=48)(key, jparams)
    ev = SampledDistributionEval(tenv, tp, tpol, terminal_index_fn(tenv),
                                 tenv.num_terminal_states, true_dist=true,
                                 mode_indices=sampled.mode_indices,
                                 num_samples=48,
                                 noise=replay_gumbel(key, tenv.max_steps))
    got = ev(0)
    assert float(got["mode_hits"]) == float(want["mode_hits"])
    for name in ("sample_tv", "sample_jsd"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
