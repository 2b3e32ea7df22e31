"""The port's FIFO replay buffer against the JAX package's
(``repro.buffer.fifo.FIFOBuffer``): wrap-around, fill level and
``valid_mask`` bitwise over a run of batches; ``sample`` and
``sample_prioritized`` on JAX's draws replayed (the indices JAX's
``randint`` drew, as uniforms, and the Gumbel rows of its
``categorical``); the raises of ``add_batch`` and ``per_shard``; and the
default selection noise.

Tolerances: none; every comparison is bitwise (the buffer moves stored
values, and Gumbel-max over replayed rows picks JAX's slots).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.buffer.fifo import FIFOBuffer as JaxFIFO  # noqa: E402
from repro_torch.buffer.fifo import BufferState, FIFOBuffer  # noqa: E402
from repro_torch.core.types import (hash_backward_gumbel,  # noqa: E402
                                    hash_select_noise, hash_step_noise)

torch.set_num_threads(2)

CAP = 7
SIZES = (3, 3, 4, 7, 2, 5)


def _np(x):
    return np.array(x)


def _items(rng, n):
    return {"x": rng.integers(-9, 9, size=(n, 2)).astype(np.int32),
            "r": rng.normal(size=(n,)).astype(np.float32),
            "done": rng.random(n) < 0.5}


def _proto():
    return {"x": np.zeros(2, np.int32), "r": np.zeros((), np.float32),
            "done": np.zeros((), bool)}


def _copy(ts):
    return BufferState({k: v.clone() for k, v in ts.data.items()},
                       ts.insert_pos.clone(), ts.size.clone())


def _filled_pair(sizes, seed=0):
    """Both buffers after the same batches; yields after every add (the
    port's state as a copy: the buffer updates it in place)."""
    rng = np.random.default_rng(seed)
    jbuf, tbuf = JaxFIFO(CAP), FIFOBuffer(CAP)
    js = jbuf.init({k: jnp.asarray(v) for k, v in _proto().items()})
    ts = tbuf.init({k: torch.from_numpy(np.array(v))
                    for k, v in _proto().items()})
    for n in sizes:
        items = _items(rng, n)
        js = jbuf.add_batch(js, {k: jnp.asarray(v) for k, v in items.items()})
        ts = tbuf.add_batch(ts, {k: torch.from_numpy(v)
                                 for k, v in items.items()})
        yield jbuf, js, tbuf, _copy(ts)


def test_add_batch_wraps_like_jax():
    for step, (jbuf, js, tbuf, ts) in enumerate(_filled_pair(SIZES)):
        for k in ("x", "r", "done"):
            np.testing.assert_array_equal(ts.data[k].numpy(), _np(js.data[k]),
                                          err_msg=f"{k} after add {step}")
        assert int(ts.insert_pos) == int(js.insert_pos)
        assert int(ts.size) == int(js.size)
        assert ts.insert_pos.dtype == ts.size.dtype == torch.int64
        assert ts.insert_pos.dim() == ts.size.dim() == 0
        np.testing.assert_array_equal(tbuf.valid_mask(ts).numpy(),
                                      _np(jbuf.valid_mask(js)))
    # the run wrapped and filled the buffer
    assert int(ts.size) == CAP


def test_add_batch_updates_the_state_in_place():
    _, _, tbuf, ts = next(_filled_pair((3,)))
    ts = _copy(ts)
    ptrs = {k: v.data_ptr() for k, v in ts.data.items()}
    pos, size = ts.insert_pos, ts.size
    out = tbuf.add_batch(ts, {k: torch.from_numpy(v) for k, v in
                              _items(np.random.default_rng(1), 2).items()})
    assert out is ts and ts.insert_pos is pos and ts.size is size
    assert {k: v.data_ptr() for k, v in ts.data.items()} == ptrs
    assert int(size) == 5 and int(pos) == 5


def _uniforms_of(idx, n):
    """JAX's slot indices as uniforms ``sample`` maps back onto them."""
    return torch.from_numpy(((np.asarray(idx, np.float64) + 0.5)
                             / max(int(n), 1)).astype(np.float32))


@pytest.mark.parametrize("after", [0, 1, 3, 5])
def test_sample_replays_jax_randint(after):
    states = list(_filled_pair(SIZES))
    jbuf, js, tbuf, ts = states[after]
    key = jax.random.PRNGKey(after)
    R = 11
    want = jbuf.sample(js, key, R)
    idx = jax.random.randint(key, (R,), 0, jnp.maximum(js.size, 1))
    got = tbuf.sample(ts, _uniforms_of(idx, js.size))
    for k in ("x", "r", "done"):
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]),
                                      err_msg=k)


def test_sample_of_an_empty_buffer_takes_slot_0():
    jbuf, tbuf = JaxFIFO(CAP), FIFOBuffer(CAP)
    js = jbuf.init({k: jnp.asarray(v) for k, v in _proto().items()})
    ts = tbuf.init({k: torch.from_numpy(np.array(v))
                    for k, v in _proto().items()})
    want = jbuf.sample(js, jax.random.PRNGKey(0), 4)
    got = tbuf.sample(ts, torch.tensor([0.01, 0.5, 0.99, 0.7]))
    np.testing.assert_array_equal(got["x"].numpy(), _np(want["x"]))


@pytest.mark.parametrize("after,temperature", [(0, 1.0), (1, 0.7),
                                               (2, 1.0), (5, 2.5)])
def test_sample_prioritized_replays_jax_categorical(after, temperature):
    """Unfilled slots are never drawn (after the first add only 3 of 7 are
    filled); the Gumbel rows are JAX's categorical's own."""
    states = list(_filled_pair(SIZES))
    jbuf, js, tbuf, ts = states[after]
    key = jax.random.PRNGKey(40 + after)
    R = 64
    want = jbuf.sample_prioritized(js, key, R, priorities=js.data["r"],
                                   temperature=temperature)
    gumbel = torch.from_numpy(_np(jax.random.gumbel(key, (R, CAP))))
    got = tbuf.sample_prioritized(ts, gumbel, ts.data["r"],
                                  torch.tensor(temperature))
    for k in ("x", "r", "done"):
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]),
                                      err_msg=k)
    if after == 0:
        slots = {tuple(r) for r in got["x"].numpy().tolist()}
        filled = {tuple(r) for r in ts.data["x"][:3].numpy().tolist()}
        assert slots <= filled


def test_add_batch_over_capacity_raises_as_jax():
    jbuf, tbuf = JaxFIFO(3), FIFOBuffer(3)
    js = jbuf.init({"x": jnp.zeros((), jnp.int32)})
    ts = tbuf.init({"x": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(ValueError) as jerr:
        jbuf.add_batch(js, {"x": jnp.zeros(4, jnp.int32)})
    with pytest.raises(ValueError) as terr:
        tbuf.add_batch(ts, {"x": torch.zeros(4, dtype=torch.int32)})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("cap,shards,min_batch", [(10, 3, 0), (8, 4, 3),
                                                  (8, 2, 4), (9, 1, 9)])
def test_per_shard_matches_jax(cap, shards, min_batch):
    try:
        want = JaxFIFO.per_shard(cap, shards, min_batch=min_batch).capacity
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            FIFOBuffer.per_shard(cap, shards, min_batch=min_batch)
        assert str(err.value) == str(e)
        return
    assert FIFOBuffer.per_shard(cap, shards,
                                min_batch=min_batch).capacity == want


def test_hash_select_noise_is_a_stream_of_its_own():
    seed = torch.full((5,), (3 << 32) | 9, dtype=torch.int64)
    index = torch.arange(5)
    u = hash_select_noise(seed, index, CAP, False)
    g = hash_select_noise(seed, index, CAP, True)
    assert u.shape == (5,) and g.shape == (5, CAP)
    assert u.dtype == g.dtype == torch.float32
    assert bool(((u > 0) & (u < 1)).all()) and bool(torch.isfinite(g).all())
    # a function of (seed, index) alone
    assert torch.equal(hash_select_noise(seed[1:3], index[1:3], CAP, True),
                       g[1:3])
    # no other draw at the same seed and row shares it
    t0 = torch.zeros(5, dtype=torch.int64)
    others = [hash_step_noise(seed, index, t0, CAP).gumbel,
              hash_step_noise(seed, index, t0, CAP).gumbel_u,
              hash_backward_gumbel(seed, index, t0, CAP)]
    for o in others:
        assert not torch.isclose(o, g).any()
