"""The port's serving engine against ``repro.serve.SamplingEngine``, on
both tiers: the full-observation one (hypergrid 2 x 6: the MLP over the
whole state at each step) and the KV-cache one (tfbind8, AMP at
``max_len=12``).

With a noise source that replays JAX's draws and the JAX recipe's
parameters carried across, a mixed pool of tempered requests gives JAX's
samples and steps bitwise and its log-rewards within 1e-6, at
``steps_per_sync`` 1, 2 and 4.  Every servable env's engine equals the
port's own ``forward_rollout`` on the hash noise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import recipes as jax_recipes  # noqa: E402
from repro.envs.registry import get_env as jax_get_env  # noqa: E402
from repro.envs.registry import make_env as jax_make_env  # noqa: E402
from repro.serve import SamplingEngine as JaxSamplingEngine  # noqa: E402
from repro_torch import recipes  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.envs.registry import get_env, make_env  # noqa: E402
from repro_torch.serve import SamplingEngine  # noqa: E402
from test_torch_serve import jax_replay_noise  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: (num_samples, seed, logit_temp, reward_beta): 9 samples over 3 requests
REQUESTS = [(4, 3, 1.0, 2.0), (3, 8, 0.7, 1.0), (2, 5, 1.3, 0.5)]
#: env name -> overrides of the parity fixtures
PARITY_ENVS = {"hypergrid": {"dim": 2, "side": 6}, "tfbind8": {},
               "amp": {"max_len": 12}}
LANES = 3


def pair(name, overrides):
    """The JAX env, params, policy and parameters of a registry entry's
    default recipe, and the port's env, params and policy holding the same
    parameters."""
    jenv = jax_make_env(name, **overrides)
    jpe = jenv.init(jax.random.PRNGKey(0))
    jpol = jax_recipes.get(jax_get_env(name).recipe).make_policy(jenv)
    jparams = jpol.init(jax.random.PRNGKey(0))
    tenv = make_env(name, **overrides)
    tpe = tenv.init(CPU)
    tpol = recipes.get_train(get_env(name).recipe).make_policy(tenv,
                                                               device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jpe, jpol, jparams), (tenv, tpe, tpol)


def run_requests(engine, requests=REQUESTS):
    ids = [engine.submit(num_samples=n, seed=s, logit_temp=lt,
                         reward_beta=rb) for n, s, lt, rb in requests]
    out = engine.run()
    return [out[i] for i in ids]


def assert_results_match(got, want):
    """Samples and steps bitwise, log-rewards within 1e-6, relative
    where they exceed 1 (``torch.log`` and ``jnp.log`` may differ by an
    ulp: 3.8e-6 at tfbind8's log-rewards of about -33)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.samples, np.asarray(w.samples))
        np.testing.assert_array_equal(g.steps, np.asarray(w.steps))
        np.testing.assert_allclose(g.log_rewards, np.asarray(w.log_rewards),
                                   atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", params=sorted(PARITY_ENVS))
def parity(request):
    """(name, JAX side, port side, JAX engine's results of REQUESTS)."""
    name = request.param
    jside, tside = pair(name, PARITY_ENVS[name])
    jeng = JaxSamplingEngine(*jside, num_lanes=LANES)
    return name, jside, tside, run_requests(jeng)


@pytest.mark.parametrize("steps_per_sync", [1, 2, 4])
def test_engine_matches_jax_engine_under_mixed_temperatures(parity,
                                                            steps_per_sync):
    name, _, (tenv, tpe, tpol), want = parity
    eng = SamplingEngine(tenv, tpe, tpol, num_lanes=LANES,
                         steps_per_sync=steps_per_sync,
                         noise=jax_replay_noise(tenv.max_steps))
    assert eng.cached == (get_env(name).serving == "kv-cache")
    got = run_requests(eng)
    assert_results_match(got, want)
    assert [r.samples.shape[0] for r in got] == [n for n, *_ in REQUESTS]
    assert not any(r.dedup for r in got)


def test_kv_env_without_the_cache_matches_jax_engine():
    """``use_cache=False`` serves a KV-capable env (tfbind8) on the
    full-observation tier, as JAX's engine does with ``use_cache=False``."""
    jside, (tenv, tpe, tpol) = pair("tfbind8", {})
    want = run_requests(JaxSamplingEngine(*jside, num_lanes=LANES,
                                          use_cache=False))
    eng = SamplingEngine(tenv, tpe, tpol, num_lanes=LANES, use_cache=False,
                         noise=jax_replay_noise(tenv.max_steps))
    assert not eng.cached
    assert_results_match(run_requests(eng), want)


@pytest.mark.parametrize("name", ["bitseq", "tfbind8", "qm9", "amp",
                                  "hypergrid", "phylo", "dag"])
def test_every_servable_env_matches_forward_rollout(name):
    """Untempered requests on the hash noise reproduce the port's
    ``forward_rollout`` per request, on 3 lanes shared by two requests; a
    beta-tempered one scales its log-rewards and nothing else."""
    env = make_env(name, **get_env(name).smoke_overrides)
    ep = env.init(CPU)
    pol = recipes.get(name).make_policy(env, device=CPU)
    eng = SamplingEngine(env, ep, pol, num_lanes=3)
    reqs = [(3, 11, 1.0, 1.0), (2, 12, 1.0, 2.0)]
    got = run_requests(eng, reqs)
    for res, (n, seed, _, beta) in zip(got, reqs):
        ref = forward_rollout(seed, env, ep, pol, n)
        np.testing.assert_array_equal(res.samples, ref.obs[-1].numpy())
        np.testing.assert_array_equal(
            res.log_rewards, (torch.tensor(beta) * ref.log_reward).numpy())
        want_steps = ref.valid.sum(0).numpy()
        np.testing.assert_array_equal(res.steps, want_steps)


def test_tempered_full_obs_request_matches_a_one_lane_engine():
    """A tempered full-observation request is independent of its lane and
    co-tenants: on a shared 3-lane pool it equals the same request alone
    on one lane (what the card's check holds it to)."""
    env = make_env("hypergrid", dim=2, side=6)
    ep = env.init(CPU)
    pol = recipes.get("hypergrid").make_policy(env, device=CPU)
    shared = run_requests(SamplingEngine(env, ep, pol, num_lanes=3),
                          [(2, 40, 1.0, 1.0), (5, 41, 0.6, 2.0)])[1]
    alone = run_requests(SamplingEngine(env, ep, pol, num_lanes=1),
                         [(5, 41, 0.6, 2.0)])[0]
    np.testing.assert_array_equal(shared.samples, alone.samples)
    np.testing.assert_array_equal(shared.log_rewards, alone.log_rewards)


def test_plans_other_than_single_are_refused():
    """Only the plans with a seed axis are refused now, with JAX's message;
    ``data_parallel`` shards the pool (over the CPU given as its devices:
    the default devices are cards), rounding the lanes up to a multiple of
    the shards; ``use_cache=True`` on an uncached env is refused."""
    from repro_torch.algo.plan import DataParallelPlan, make_plan
    env = make_env("hypergrid", dim=2, side=6)
    ep = env.init(CPU)
    pol = recipes.get("hypergrid").make_policy(env, device=CPU)
    SamplingEngine(env, ep, pol, plan="single")
    for plan in (make_plan("vmap_seeds", num_seeds=2),
                 make_plan("seeds_x_data", num_seeds=2,
                           devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="no seed axis"):
            SamplingEngine(env, ep, pol, plan=plan)
    eng = SamplingEngine(env, ep, pol, num_lanes=5,
                         plan=DataParallelPlan(devices=["cpu"] * 2))
    assert eng.num_lanes == 6 and [len(l.t) for l in eng.lanes] == [3, 3]
    with pytest.raises(ValueError, match="use_cache=True"):
        SamplingEngine(env, ep, pol, use_cache=True)
