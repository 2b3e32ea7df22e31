"""The port's decode-arch policy against the JAX package's, with the JAX
policy's initialised parameters carried across by
``repro_torch.convert.params_from_jax``.

Over a whole bitseq trajectory the port's fused ``sample_cached`` (on the
CPU: the plain version of the fused kernel) and its own unfused chain
(``apply_cached`` + ``sample_masked``) are held against JAX's unfused
``apply_cached`` + ``sample_masked_per_env`` chain, fed the Gumbel noise
JAX's categorical draw consumes.  Actions must be equal; logits, log-probs
and caches agree to 1e-5 (fp32, different reduction order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import make_transformer_policy  # noqa: E402
from repro.core.types import derive_env_keys, sample_masked_per_env  # noqa: E402
from repro.envs.bitseq import BitSeqEnvironment as JaxBitSeq  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policies import TransformerPolicy  # noqa: E402
from repro_torch.core.types import sample_masked  # noqa: E402
from repro_torch.envs.bitseq import BitSeqEnvironment  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
SMALL = dict(num_layers=2, dim=32, num_heads=4)
FULL = dict(num_layers=3, dim=64, num_heads=8)


def _pair(n, k, arch, seed=0):
    """(JAX env, policy, params) and the port's, same parameters."""
    jenv = JaxBitSeq(n=n, k=k)
    jpol = make_transformer_policy(jenv.vocab_size, jenv.L, jenv.action_dim,
                                   jenv.backward_action_dim, arch="decode",
                                   **arch)
    jparams = jpol.init(jax.random.PRNGKey(seed))
    tenv = BitSeqEnvironment(n=n, k=k)
    tpol = TransformerPolicy(tenv.vocab_size, tenv.L, tenv.action_dim,
                             device=CPU, **arch)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    return (jenv, jpol, jparams), (tenv, tpol)


def _np(x):
    return np.array(x)          # a writable copy, safe for torch.from_numpy


def test_param_names_match_the_jax_checkpoint_names():
    from repro.checkpoint.manager import _flatten
    (_, _, jparams), (_, tpol) = _pair(16, 4, SMALL)
    names = {n for n, _ in _flatten(jparams)[0]}
    assert names == set(tpol.params.flat())
    assert names == set(params_from_jax(jax.device_get(jparams)))


@pytest.mark.parametrize("batch", [1, 5])
def test_full_pass_matches_jax(batch):
    (jenv, jpol, jparams), (tenv, tpol) = _pair(16, 4, SMALL)
    rng = np.random.RandomState(batch)
    tokens = rng.randint(0, jenv.vocab_size,
                         size=(batch, jenv.L)).astype(np.int32)
    jout = jpol.apply(jparams, jnp.asarray(tokens))
    tout = tpol.apply(torch.from_numpy(tokens))
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), _np(jout[k]), **TOL)


def _trajectory_parity(n, k, arch, B, seed, temp):
    (jenv, jpol, jparams), (tenv, tpol) = _pair(n, k, arch, seed)
    jp, tp = jenv.init(jax.random.PRNGKey(0)), tenv.init(CPU)
    T, A = jenv.max_steps, jenv.action_dim
    env_keys = derive_env_keys(jax.random.split(jax.random.PRNGKey(seed), T),
                               jnp.arange(B))
    logit_temp = np.linspace(0.7, 1.3, B).astype(np.float32) if temp \
        else None
    gumbel_of = jax.jit(jax.vmap(
        lambda key: jax.random.gumbel(jax.random.split(key, 3)[1], (A,))))

    @jax.jit
    def jax_step(jcache, token, pos, length, t, mask, keys):
        out, jcache = jpol.apply_cached(jparams, jcache, token, pos, length,
                                        step=t)
        logits = out["logits"] if logit_temp is None \
            else out["logits"] * jnp.asarray(logit_temp)[:, None]
        a, lp = sample_masked_per_env(None, logits, mask, env_keys=keys)
        return a, lp, out, jcache

    jcache = jpol.cache_init(jparams, B)
    tcache = tpol.cache_init(B)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]),
                                   **TOL)
    _, js = jenv.reset(B, jp)
    _, ts = tenv.reset(B, tp)
    prev = np.zeros(B, np.int32)
    for t in range(T):
        jmask = jnp.logical_or(jenv.forward_mask(js, jp),
                               jenv.is_terminal(js, jp)[:, None])
        tmask = tenv.forward_mask(ts, tp) | tenv.is_terminal(ts, tp)[:, None]
        jtok, jpos, jlen = jenv.observe_last(js, jp, jnp.asarray(prev))
        ttok, tpos, tlen = tenv.observe_last(ts, tp, torch.from_numpy(prev))
        ja, jlp, jout, jcache = jax_step(jcache, jtok, jpos, jlen, t, jmask,
                                         env_keys[t])
        # the plain chain: the port's apply_cached on a copy of the cache
        pout, _ = tpol.apply_cached(
            {k: v.clone() for k, v in tcache.items()}, ttok, tpos, tlen,
            step=t)
        np.testing.assert_allclose(pout["logits"].numpy(),
                                   _np(jout["logits"]), **TOL)
        np.testing.assert_allclose(pout["log_flow"].numpy(),
                                   _np(jout["log_flow"]), **TOL)
        gumbel = torch.from_numpy(_np(gumbel_of(env_keys[t])))
        plogits = pout["logits"] if logit_temp is None \
            else pout["logits"] * torch.from_numpy(logit_temp)[:, None]
        pa, plp = sample_masked(plogits, tmask, gumbel)
        np.testing.assert_array_equal(pa.numpy(), _np(ja))
        np.testing.assert_allclose(plp.numpy(), _np(jlp), **TOL)
        ta, tlp, y, tcache = tpol.sample_cached(
            tcache, ttok, tpos, tlen, gumbel, tmask, step=t,
            logit_temp=None if logit_temp is None
            else torch.from_numpy(logit_temp))
        np.testing.assert_array_equal(ta.numpy(), _np(ja))
        np.testing.assert_allclose(tlp.numpy(), _np(jlp), **TOL)
        np.testing.assert_allclose(tpol.heads(y)["logits"].numpy(),
                                   _np(jout["logits"]), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       _np(jcache[name]), **TOL)
        _, js, _, _, _ = jenv.step(js, ja, jp)
        _, ts, _, _ = tenv.step(ts, ta.long(), tp)
        prev = _np(ja)
    np.testing.assert_array_equal(ts.tokens.numpy(), _np(js.tokens))


@pytest.mark.parametrize("temp", [False, True], ids=["temp1", "tempered"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cached_trajectory_matches_jax_small(seed, temp):
    _trajectory_parity(16, 4, SMALL, B=4, seed=seed, temp=temp)


def test_cached_trajectory_matches_jax_full_width():
    """bitseq n=120, k=8 (A=3840) with the recipe's 3-layer, dim-64,
    8-head policy."""
    _trajectory_parity(120, 8, FULL, B=3, seed=2, temp=False)


def test_load_params_rejects_mismatched_trees():
    (_, _, jparams), (_, tpol) = _pair(16, 4, SMALL)
    flat = params_from_jax(jax.device_get(jparams))
    with pytest.raises(KeyError):
        tpol.load_params({k: v for k, v in flat.items() if k != "log_z"})
    bad = dict(flat)
    bad["bos"] = torch.zeros(3)
    with pytest.raises(ValueError):
        tpol.load_params(bad)


@pytest.mark.parametrize("update", ["in_place", "adam_step",
                                    "adam_foreach_step"])
def test_fused_step_follows_in_place_weight_updates(update):
    """``kernel_weights()`` keeps stacked copies of the decoder weights for
    the fused step.  After a weight is updated in place (by hand, or by an
    optimizer step on a trainable policy: Adam's single-tensor update,
    the CPU's default, and its multi-tensor ``foreach`` update, the
    default on a GPU) the fused ``sample_cached`` must still equal the
    plain ``apply_cached`` + ``sample_masked`` chain."""
    (jenv, _, jparams), _ = _pair(16, 4, SMALL)
    tenv = BitSeqEnvironment(n=16, k=4)
    tpol = TransformerPolicy(tenv.vocab_size, tenv.L, tenv.action_dim,
                             device=CPU, requires_grad=update != "in_place",
                             **SMALL)
    tpol.load_params(params_from_jax(jax.device_get(jparams)))
    tp = tenv.init(CPU)
    B = 5
    rng = np.random.RandomState(0)
    _, ts = tenv.reset(B, tp)
    prev = torch.zeros(B, dtype=torch.int64)

    def step_pair(t, cache):
        mask = tenv.forward_mask(ts, tp)
        tok, pos, length = tenv.observe_last(ts, tp, prev)
        gumbel = torch.from_numpy(
            -np.log(-np.log(rng.rand(B, tenv.action_dim)))).float()
        with torch.no_grad():
            out, _ = tpol.apply_cached({k: v.clone() for k, v in
                                        cache.items()}, tok, pos, length,
                                       step=t)
            pa, plp = sample_masked(out["logits"], mask, gumbel)
            fa, flp, y, cache = tpol.sample_cached(cache, tok, pos, length,
                                                   gumbel, mask, step=t)
        np.testing.assert_array_equal(fa.numpy(), pa.numpy())
        np.testing.assert_allclose(flp.numpy(), plp.numpy(), **TOL)
        np.testing.assert_allclose(tpol.heads(y)["logits"].detach().numpy(),
                                   out["logits"].numpy(), **TOL)
        return fa.long(), cache

    prev, cache = step_pair(0, tpol.cache_init(B))   # fills the weight cache
    w = tpol.params["decoder"]["layer_0"]["ff1"]["w"]
    before = w.detach().clone()
    if update == "in_place":
        with torch.no_grad():
            w.mul_(1.5)
    else:
        opt = torch.optim.Adam(tpol.params.parameters(), lr=0.05,
                               foreach=update == "adam_foreach_step")
        tokens = torch.from_numpy(rng.randint(0, tenv.vocab_size,
                                              size=(B, tenv.L)))
        tpol.apply(tokens)["logits"].square().mean().backward()
        opt.step()
    assert not torch.equal(w.detach(), before)
    torch.testing.assert_close(tpol.kernel_weights()["stacked"]["ff1_w"][0],
                               w.detach(), rtol=0, atol=0)
    _, ts, _, _ = tenv.step(ts, prev, tp)
    step_pair(1, cache)
