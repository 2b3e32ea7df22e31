"""The port's bitseq environment and reward against the JAX package's, on
random legal action sequences drawn with numpy.  Exact equality: the env
is integer arithmetic and the reward the same fp32 expression (against a
jitted JAX step the reward may sit one ulp away, see below)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro.envs.transforms import RewardExponent as JaxRewardExponent  # noqa: E402
from repro.envs.transforms import TransformedParams as JaxTransformed  # noqa: E402
from repro.rewards.bitseq import make_mode_set as jax_make_mode_set  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402
from repro_torch.envs.transforms import (RewardExponent,  # noqa: E402
                                         TransformedParams)
from repro_torch.rewards.bitseq import make_mode_set  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed,n,num_modes", [(0, 16, 60), (3, 120, 60),
                                              (7, 40, 12), (11, 120, 5)])
def test_mode_sets_are_identical(seed, n, num_modes):
    np.testing.assert_array_equal(make_mode_set(seed, n, num_modes),
                                  jax_make_mode_set(seed, n, num_modes))


@pytest.mark.parametrize("n,k", [(16, 4), (120, 8)])
def test_reward_params_are_identical(n, k):
    jenv, tenv = JaxBitSeq(n=n, k=k, seed=5), BitSeqEnvironment(n=n, k=k,
                                                                seed=5)
    jp = jenv.init(jax.random.PRNGKey(0))
    tp = tenv.init(CPU)
    for key in ("modes", "mode_words", "beta"):
        np.testing.assert_array_equal(tp.reward_params[key].numpy(),
                                      np.asarray(jp.reward_params[key]))


def _legal_action(rng, mask):
    """One uniformly drawn legal action per row (any action on an
    all-illegal row, which only a terminal row has)."""
    out = []
    for row in mask:
        legal = np.nonzero(row)[0]
        out.append(rng.choice(legal) if legal.size else
                   rng.randint(row.size))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,k", [(16, 4), (120, 8)])
def test_env_matches_jax_on_random_trajectories(n, k, seed):
    B = 6
    rng = np.random.RandomState(seed)
    jenv, tenv = JaxBitSeq(n=n, k=k), BitSeqEnvironment(n=n, k=k)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    _, js = jenv.reset(B, jp)
    _, ts = tenv.reset(B, tp)
    jstep = jax.jit(jenv.step)
    # two steps past the horizon: step must no-op on terminal rows
    for t in range(tenv.L + 2):
        jmask = np.asarray(jenv.forward_mask(js, jp))
        tmask = tenv.forward_mask(ts, tp)
        np.testing.assert_array_equal(tmask.numpy(), jmask)
        np.testing.assert_array_equal(tenv.is_terminal(ts, tp).numpy(),
                                      np.asarray(jenv.is_terminal(js, jp)))
        a = _legal_action(rng, jmask)
        _, js, jlr, jdone, _ = jstep(js, jnp.asarray(a), jp)
        _, ts, tlr, tdone = tenv.step(ts, torch.from_numpy(a), tp)
        np.testing.assert_array_equal(ts.tokens.numpy(),
                                      np.asarray(js.tokens))
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        # jit lets XLA turn the reward's division by n into a multiply by
        # 1/n, one ulp away; the eager reward below is compared exactly
        np.testing.assert_array_max_ulp(tlr.numpy(), np.asarray(jlr),
                                        maxulp=1)
        jlast = jenv.observe_last(js, jp, jnp.asarray(a))
        tlast = tenv.observe_last(ts, tp, torch.from_numpy(a))
        for x, y in zip(tlast, jlast):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert x.dtype == torch.int32
    assert bool(tdone.all())
    np.testing.assert_array_equal(tenv.log_reward(ts, tp).numpy(),
                                  np.asarray(jenv.log_reward(js, jp)))


@pytest.mark.parametrize("n,k", [(16, 4), (120, 8)])
def test_per_row_reward_exponent_matches_jax(n, k):
    """The engine's per-lane beta vector scales each row's log-reward."""
    B = 5
    rng = np.random.RandomState(4)
    words = rng.randint(0, 2 ** k, size=(B, n // k)).astype(np.int32)
    beta = np.asarray([0.5, 1.0, 2.0, 3.5, 1.0], np.float32)
    jenv, tenv = JaxBitSeq(n=n, k=k), BitSeqEnvironment(n=n, k=k)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    js = jenv.terminal_state_from_words(jnp.asarray(words))
    ts = type(tenv.reset(B, tp)[1])(tokens=torch.from_numpy(words),
                                   steps=torch.full((B,), n // k,
                                                    dtype=torch.int32))
    jlr = JaxRewardExponent(jenv).log_reward(
        js, JaxTransformed(inner=jp, extra={"beta": jnp.asarray(beta)}))
    tlr = RewardExponent(tenv).log_reward(
        ts, TransformedParams(inner=tp,
                              extra={"beta": torch.from_numpy(beta)}))
    np.testing.assert_array_equal(tlr.numpy(), np.asarray(jlr))
