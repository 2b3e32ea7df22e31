"""The port's serving slice as a whole, at bitseq n=16, k=4.

- With a noise source that replays JAX's own draws
  (``gumbel(split(fold_in(split(key, T)[t], i), 3)[1], (A,))``), the port's
  engine gives ``repro.serve.SamplingEngine``'s terminal tokens for a mixed
  pool of requests, from the same (carried-across) parameters.
- With the default hash noise, engine samples equal the port's own
  ``forward_rollout`` token for token, for any lane count.
- The scheduler, request validation and the one-shot CLI run on the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import recipes as jax_recipes  # noqa: E402
from repro.envs.registry import make_env  # noqa: E402
from repro.serve import SamplingEngine as JaxSamplingEngine  # noqa: E402
from repro_torch import recipes  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.rollout import forward_rollout  # noqa: E402
from repro_torch.core.types import hash_gumbel  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import (BadRequest, SampleRequest,  # noqa: E402
                               SamplingEngine, Scheduler)

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K = 16, 4
# (num_samples, seed, logit_temp, reward_beta): 7 samples over 2 requests
REQUESTS = [(4, 3, 1.0, 2.0), (3, 8, 0.7, 1.0)]


def jax_replay_noise(T):
    """Noise source replaying JAX's categorical draws: row (seed, i, t)
    gets the Gumbel noise ``sample_masked`` consumes for sample i at step t
    of a request keyed ``PRNGKey(seed)``."""

    @jax.jit
    def rows(seeds, ids, ts, shape_a):
        def one(s, i, t):
            step_key = jax.random.split(jax.random.PRNGKey(s), T)[t]
            key_c = jax.random.split(jax.random.fold_in(step_key, i), 3)[1]
            return jax.random.gumbel(key_c, shape_a.shape)
        return jax.vmap(one)(seeds, ids, ts)

    def noise(seed, index, t, num_actions):
        out = rows(jnp.asarray(seed.numpy(), jnp.int32),
                   jnp.asarray(index.numpy(), jnp.int32),
                   jnp.asarray(t.numpy(), jnp.int32),
                   jnp.zeros((num_actions,)))
        return torch.from_numpy(np.array(out))

    return noise


@pytest.fixture(scope="module")
def bitseq():
    """The JAX recipe's env/policy/params and the port's, same params."""
    jenv = make_env("bitseq", n=N, k=K)
    jparams_env = jenv.init(jax.random.PRNGKey(0))
    jpol = jax_recipes.get("bitseq_tb").make_policy(jenv)
    jparams = jpol.init(jax.random.PRNGKey(0))
    recipe = recipes.get("bitseq")
    tenv = recipe.make_env(n=N, k=K)
    tparams_env = tenv.init(CPU)
    tpol = recipe.make_policy(tenv, device=CPU)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jparams_env, jpol, jparams), (tenv, tparams_env, tpol)


def test_engine_matches_jax_engine_with_replayed_noise(bitseq):
    (jenv, jpe, jpol, jparams), (tenv, tpe, tpol) = bitseq
    jeng = JaxSamplingEngine(jenv, jpe, jpol, jparams, num_lanes=3)
    teng = SamplingEngine(tenv, tpe, tpol, num_lanes=3,
                          noise=jax_replay_noise(tenv.max_steps))
    jids = [jeng.submit(num_samples=n, seed=s, logit_temp=lt, reward_beta=rb)
            for n, s, lt, rb in REQUESTS]
    tids = [teng.submit(num_samples=n, seed=s, logit_temp=lt, reward_beta=rb)
            for n, s, lt, rb in REQUESTS]
    jout, tout = jeng.run(), teng.run()
    for jid, tid, (n, _, _, _) in zip(jids, tids, REQUESTS):
        assert tout[tid].samples.shape == (n, tenv.L)
        np.testing.assert_array_equal(tout[tid].samples, jout[jid].samples)
        np.testing.assert_allclose(tout[tid].log_rewards,
                                   jout[jid].log_rewards, atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(tout[tid].steps, jout[jid].steps)


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_engine_matches_forward_rollout_for_any_lane_count(bitseq, lanes):
    _, (tenv, tpe, tpol) = bitseq
    eng = SamplingEngine(tenv, tpe, tpol, num_lanes=lanes)
    rids = [eng.submit(num_samples=n, seed=s) for n, s in ((5, 21), (4, 22))]
    out = eng.run()
    for rid, (n, s) in zip(rids, ((5, 21), (4, 22))):
        ref = forward_rollout(s, tenv, tpe, tpol, n)
        np.testing.assert_array_equal(out[rid].samples, ref.obs[-1].numpy())
        np.testing.assert_array_equal(out[rid].log_rewards,
                                      ref.log_reward.numpy())
    assert eng.steps_run > 0 and not eng.has_work


def test_tempered_engine_matches_tempered_rollout(bitseq):
    _, (tenv, tpe, tpol) = bitseq
    eng = SamplingEngine(tenv, tpe, tpol, num_lanes=2)
    rid = eng.submit(num_samples=3, seed=5, logit_temp=0.6, reward_beta=2.0)
    res = eng.run()[rid]
    ref = forward_rollout(5, tenv, tpe, tpol, 3, logit_temp=0.6)
    np.testing.assert_array_equal(res.samples, ref.obs[-1].numpy())
    np.testing.assert_array_equal(res.log_rewards,
                                  (2.0 * ref.log_reward).numpy())


def test_hash_noise_rows_are_independent_and_gumbel_distributed():
    seeds = torch.tensor([7, 7, 8, 2 ** 40 + 7], dtype=torch.int64)
    ids = torch.tensor([0, 1, 0, 0], dtype=torch.int64)
    ts = torch.tensor([3, 3, 3, 3], dtype=torch.int64)
    g = hash_gumbel(seeds, ids, ts, 64)
    for i in range(4):
        assert torch.equal(hash_gumbel(seeds[i:i + 1], ids[i:i + 1],
                                       ts[i:i + 1], 64)[0], g[i])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert not torch.equal(g[0], g[3])        # the seed's high word counts
    big = hash_gumbel(torch.arange(64), torch.zeros(64, dtype=torch.int64),
                      torch.zeros(64, dtype=torch.int64), 3840)
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(big.mean()) - 0.5772157) < 0.01
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_hash_uniforms_stay_below_one():
    """Every 32-bit hash value, the all-ones top bits included, gives a
    uniform strictly inside (0, 1), so every Gumbel draw is finite (from
    24 bits the top code rounded to 1.0 in float32: a Gumbel of +inf that
    picked a masked action)."""
    from repro_torch.core.types import _uniform_of_bits
    h = torch.tensor([0, 511, 512, 2 ** 31, 2 ** 32 - 512, 2 ** 32 - 1],
                     dtype=torch.int64)
    u = _uniform_of_bits(h)
    assert bool((u > 0).all()) and bool((u < 1).all())
    assert float(u[-1]) == 1 - 2.0 ** -24 and float(u[0]) == 2.0 ** -24
    assert u[1] == u[0] and u[2] > u[1] and u[-2] == u[-1]
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_scheduler_coalesces_and_validates():
    sched = Scheduler(num_lanes=3, device="cpu")
    base = dict(env="bitseq", overrides={"n": N, "k": K})
    r0 = sched.submit(SampleRequest(num_samples=2, seed=1, **base))
    r1 = sched.submit(SampleRequest(num_samples=3, seed=2, reward_beta=2.0,
                                    **base))
    assert sched.num_engines == 1
    out = sched.run()
    assert set(out) == {r0, r1}
    assert [len(out[r].samples) for r in (r0, r1)] == [2, 3]
    with pytest.raises(BadRequest):
        sched.submit(SampleRequest(env="ising"))
    with pytest.raises(BadRequest):
        SampleRequest.from_dict({"env": "bitseq", "deadline_s": 0.0})
    with pytest.raises(BadRequest):
        SampleRequest.from_dict({"env": "bitseq", "checkpoint": 3})
    with pytest.raises(BadRequest):
        SampleRequest.from_dict({"env": "bitseq", "logit_temp": -1.0})


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recipes.get("bitseq").make_env(n=N, k=K).init()


def test_launch_serve_runs_on_cpu(capsys):
    rc = serve_cli.main(["--env", "bitseq", "--smoke", "--device", "cpu",
                         "--num-samples", "3", "--seed", "7", "--lanes", "2",
                         "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["samples"]) == 3 and doc["steps"] == [N // K] * 3
    assert all(np.isfinite(doc["log_rewards"]))
