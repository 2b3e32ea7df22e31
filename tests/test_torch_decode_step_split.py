"""The arithmetic of the cluster-split decode_step kernel, emulated on the CPU.

``decode_step.cu`` gives a tile of ``kTile`` lanes to a cluster of
``kRanks`` blocks (both read from the source below).  Every GEMV there
splits K into ``32 / CPW`` row slices (CPW: the column pairs a warp takes
at once, also read from the source): a slice sums its rows in order with
``fmaf`` and the slices meet in an xor-shuffle tree (offsets 16, 8, ...,
CPW).  Each rank owns a share of the columns (chunks of a multiple of 4),
of the heads, and of the readout's A columns.  The readout then merges,
in rank order, first every slice's (max, sum of exp) into lse, then every
slice's argmax of ``(ml - lse) + g`` (ties to the lowest index).
:func:`emulate_step` repeats that decomposition in plain torch (``fmaf``
as one rounding through float64; sums as the kernel's per-thread runs and
shuffle trees, never a torch reduction) and is held against
``ref_decode_step`` and the JAX package's ``ref_decode_step`` at the
bitseq width and at a ragged shape (A = 203 over 8 ranks), on planted
ties across two slices, a slice whose actions are all masked and a row
with one legal action.  A lane's outputs are bitwise the same alone or
beside any neighbours, first or last in its tile.  The planted case at
the end shows why the argmax takes ``(ml - lse) + g``: the shortcut
``ml + g`` picks another action there.  Inputs are drawn with numpy from a
seed.  Tolerance 1e-5 (abs and rel): fp32 in other summation orders.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_decode_step as jax_ref_decode_step  # noqa: E402
from repro_torch.kernels.ref import ref_decode_step  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = torch.float32
FMAX = torch.finfo(F32).max
_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
        / "csrc" / "decode_step.cu").read_text()
RANKS = int(re.search(r"constexpr int kRanks = (\d+);", _SRC).group(1))
TILE = int(re.search(r"constexpr int kTile = (\d+);", _SRC).group(1))
#: column pairs a warp takes at once: 2 in the stack's GEMVs, 8 in the
#: readout (``gemv<2>`` / ``gemv<8>`` in the source)
STACK_CPW, READOUT_CPW = (int(re.search(pat, _SRC).group(1)) for pat in (
    r"gemv<(\d+)>\(", r"gemv<(\d+)>\(g, layer_gemv\(a\.w_out"))


def fma(a, b, c):
    """fmaf: the exact a * b + c, rounded once (through float64)."""
    return (a.double() * b.double() + c.double()).to(F32)


def shuffle_tree(parts):
    """Sum over dim 0 (32 / CPW thread partials) as the xor-shuffle steps
    do: at offset k every partial adds the one k away."""
    n = parts.shape[0]
    idx = torch.arange(n)
    k = n // 2
    while k:
        parts = parts + parts[idx ^ k]
        k //= 2
    return parts[0]


def thread_runs(vals, nthreads=32, combine=None):
    """Per-thread partials of a strided loop ``for (i = t; i < n; i +=
    32)`` over the last dim of ``vals``: (32, ...) in the kernel's order."""
    n = vals.shape[-1]
    parts = torch.zeros((nthreads,) + vals.shape[:-1], dtype=F32)
    for i in range(n):
        parts[i % nthreads] = (parts[i % nthreads] + vals[..., i]
                               if combine is None
                               else combine(parts[i % nthreads], vals[..., i]))
    return parts


def split_cols(n, r):
    chunk = (-(-n // RANKS) + 3) & ~3
    j0 = min(r * chunk, n)
    return j0, min(j0 + chunk, n)


def gemv(x, w, cpw=STACK_CPW):
    """x (n, K) @ w (K, N) as ``gemv<CPW>``: 32 / CPW row slices, each
    summing its rows s, s + 32 / CPW, ... with fmaf, then the shuffle
    tree.  Every column's sum is the same whichever rank owns it."""
    ns = 32 // cpw
    K = w.shape[0]
    acc = torch.zeros(ns, x.shape[0], w.shape[1], dtype=F32)
    for base in range(0, K, ns):
        rows = torch.arange(base, min(base + ns, K))
        s = rows - base
        acc[s] = fma(w[rows][:, None, :], x[:, rows].T[:, :, None], acc[s])
    return shuffle_tree(acc)


def warp_sum(parts):
    return shuffle_tree(parts)


def layernorm(h, scale, bias):
    D = h.shape[-1]
    mu = warp_sum(thread_runs(h)) / D
    d = h - mu[:, None]
    var = warp_sum(thread_runs(d, combine=lambda s, v: fma(v, v, s))) / D
    r = 1.0 / torch.sqrt(var + 1e-5)
    return fma(d * r[:, None], scale, bias)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


def attention(q, k, v, nv, hd):
    """A warp per (lane, head): thread c scores slots c, c + 32, ...; max;
    exp; the denominator by a warp sum; thread d sums p_c v[c, d] over c
    in order.
    q (n, H, hd); k/v (n, C, H, hd); nv (n,)."""
    n, C, H, _ = k.shape
    dot = torch.zeros(n, C, H, dtype=F32)
    for i in range(hd):
        dot = fma(q[:, None, :, i], k[..., i], dot)
    live = torch.arange(C)[None, :, None] < nv[:, None, None]
    sc = dot / math.sqrt(hd)
    m = torch.where(live, sc, -FMAX).amax(1, keepdim=True)
    p = torch.where(live, torch.exp(sc - m), 0.0)          # (n, C, H)
    den = warp_sum(thread_runs(p.permute(0, 2, 1)))        # (n, H)
    o = torch.zeros(n, H, hd, dtype=F32)
    for c in range(C):
        o = torch.where(live[:, c, :, None],
                        fma(p[:, c, :, None], v[:, c], o), o)
    return (o / torch.clamp(den, min=1e-30)[..., None]).reshape(n, H * hd)


def readout_sample(y, w_out, b_out, temp, mask, gumbel, *, shortcut=False):
    """The readout and the two rank-order merges.  ``shortcut`` takes the
    argmax of ml + g instead of (ml - lse) + g."""
    n, A = mask.shape
    logits = (gemv(y, w_out, READOUT_CPW) + b_out) * temp[:, None]
    ml = torch.where(mask, logits, -FMAX)
    stats = []
    for r in range(RANKS):
        j0, j1 = split_cols(A, r)
        sl = ml[:, j0:j1]
        m_r = sl.amax(1) if j1 > j0 else torch.full((n,), -FMAX)
        m_r = torch.maximum(m_r, torch.tensor(-FMAX))
        s_r = warp_sum(thread_runs(torch.exp(sl - m_r[:, None])))
        stats.append((m_r, s_r))
    m = torch.full((n,), -FMAX)
    for m_r, _ in stats:
        m = torch.maximum(m, m_r)
    se = torch.zeros(n, dtype=F32)
    for m_r, s_r in stats:
        se = fma(s_r, torch.exp(m_r - m), se)
    lse = m + torch.log(se)
    value = ml + gumbel if shortcut else (ml - lse[:, None]) + gumbel
    best_v = torch.full((n,), -math.inf)
    best_i = torch.full((n,), 2 ** 31 - 1, dtype=torch.int64)
    for r in range(RANKS):                       # rank order, strict >
        j0, j1 = split_cols(A, r)
        if j1 == j0:
            continue
        v_r, i_r = value[:, j0:j1].max(1)        # first maximum: lowest index
        better = v_r > best_v
        best_v = torch.where(better, v_r, best_v)
        best_i = torch.where(better, i_r + j0, best_i)
    log_pf = torch.gather(ml, 1, best_i[:, None])[:, 0] - lse
    return best_i.to(torch.int32), log_pf, lse


def emulate_step(w, x_new, k_cache, v_cache, lengths, slot, gumbel, mask,
                 w_out, b_out, temp, num_heads):
    """``decode_step.cu``'s arithmetic, a tile of TILE lanes at a time
    (dead lanes of a partial tile padded as the kernel pads them).
    Functional: returns (action, log_pf, y, new_k, new_v)."""
    L, B, C, D = k_cache.shape
    H, hd = num_heads, D // num_heads
    new_k, new_v = k_cache.clone(), v_cache.clone()
    temp = torch.ones(B) if temp is None else temp
    outs = []
    for lane0 in range(0, B, TILE):
        live = min(TILE, B - lane0)
        pad = lambda t, fill=0: torch.cat(  # noqa: E731
            [t[lane0:lane0 + live],
             torch.full((TILE - live,) + tuple(t.shape[1:]), fill,
                        dtype=t.dtype)])
        x, ln, sl = pad(x_new), pad(lengths), pad(slot, -1)
        nv = torch.where(torch.arange(TILE) < live,
                         torch.clamp(ln + 1, max=C), 0)
        kc = torch.cat([new_k[:, lane0:lane0 + live],
                        torch.zeros(L, TILE - live, C, D)], 1)
        vc = torch.cat([new_v[:, lane0:lane0 + live],
                        torch.zeros(L, TILE - live, C, D)], 1)
        rows = torch.arange(TILE)
        ok = (rows < live) & (sl >= 0) & (sl < C)
        for l in range(L):
            kv = gemv(x, w["kv_w"][l]) + w["kv_b"][l]
            kc[l, rows[ok], sl[ok].long()] = kv[ok, :D]
            vc[l, rows[ok], sl[ok].long()] = kv[ok, D:]
        h = w["q0"][None].expand(TILE, D).clone()
        for l in range(L):
            g = layernorm(h, w["ln1_scale"][l], w["ln1_bias"][l])
            q = gemv(g, w["q_w"][l]) + w["q_b"][l]
            o = attention(q.reshape(TILE, H, hd),
                          kc[l].reshape(TILE, C, H, hd),
                          vc[l].reshape(TILE, C, H, hd), nv, hd)
            h = (h + gemv(o, w["proj_w"][l])) + w["proj_b"][l]
            g = layernorm(h, w["ln2_scale"][l], w["ln2_bias"][l])
            ff = gelu_tanh(gemv(g, w["ff1_w"][l]) + w["ff1_b"][l])
            h = (h + gemv(ff, w["ff2_w"][l])) + w["ff2_b"][l]
        y = layernorm(h, w["ln_f_scale"], w["ln_f_bias"])
        action, log_pf, _ = readout_sample(y, w_out, b_out, pad(temp, 1.0),
                                           pad(mask, False), pad(gumbel))
        new_k[:, lane0:lane0 + live] = kc[:, :live]
        new_v[:, lane0:lane0 + live] = vc[:, :live]
        outs.append((action[:live], log_pf[:live], y[:live]))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs]), new_k, new_v)


# -- inputs ---------------------------------------------------------------------

def _inputs(seed, B, L, C, D, H, F, A):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (scale * rng.randn(*s)).astype(np.float32)  # noqa: E731,E501
    w = {"ln1_scale": 1 + f(L, D, scale=0.1), "ln1_bias": f(L, D, scale=0.1),
         "q_w": f(L, D, D, scale=D ** -0.5), "q_b": f(L, D, scale=0.1),
         "kv_w": f(L, D, 2 * D, scale=D ** -0.5),
         "kv_b": f(L, 2 * D, scale=0.1),
         "proj_w": f(L, D, D, scale=D ** -0.5), "proj_b": f(L, D, scale=0.1),
         "ln2_scale": 1 + f(L, D, scale=0.1), "ln2_bias": f(L, D, scale=0.1),
         "ff1_w": f(L, D, F, scale=D ** -0.5), "ff1_b": f(L, F, scale=0.1),
         "ff2_w": f(L, F, D, scale=F ** -0.5), "ff2_b": f(L, D, scale=0.1),
         "ln_f_scale": 1 + f(D, scale=0.1), "ln_f_bias": f(D, scale=0.1),
         "q0": f(D, scale=0.5)}
    lengths = rng.randint(0, C - 1, size=B).astype(np.int32)
    mask = rng.rand(B, A) < 0.5
    mask[:, 0] |= ~mask.any(-1)
    return dict(
        w=w, x_new=f(B, D, scale=0.5), k=f(L, B, C, D), v=f(L, B, C, D),
        lengths=lengths, slot=np.clip(lengths, 1, C - 1).astype(np.int32),
        gumbel=rng.gumbel(size=(B, A)).astype(np.float32), mask=mask,
        w_out=f(D, A, scale=D ** -0.5), b_out=f(A, scale=0.1),
        temp=(0.5 + rng.rand(B)).astype(np.float32))


def _args(inp, temp=True):
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items() if k != "w"}
    w = {k: torch.from_numpy(v) for k, v in inp["w"].items()}
    return (w, t["x_new"], t["k"], t["v"], t["lengths"], t["slot"],
            t["gumbel"], t["mask"], t["w_out"], t["b_out"],
            t["temp"] if temp else None)


def _check_against_plain(inp, H, temp=True, jax=False):
    args = _args(inp, temp)
    got = emulate_step(*args, num_heads=H)
    want = ref_decode_step(*args, num_heads=H)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for name, a, b in zip(("log_pf", "y", "new_k", "new_v"), got[1:],
                          want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)
    if jax:
        ja = jax_ref_decode_step(
            {k: jnp.asarray(v) for k, v in inp["w"].items()},
            *(jnp.asarray(inp[k]) for k in ("x_new", "k", "v", "lengths",
                                            "slot", "gumbel", "mask",
                                            "w_out", "b_out")),
            jnp.asarray(inp["temp"]) if temp else None, num_heads=H)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ja[0]))
        for name, a, b in zip(("log_pf", "y", "new_k", "new_v"), got[1:],
                              ja[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **TOL)
    return got


#: the bitseq policy's widths (n=120, k=8): D 64, 8 heads, F 256, A 3840
BITSEQ = dict(D=64, H=8, F=256, A=3840)


@pytest.mark.parametrize("temp", [False, True], ids=["temp1", "tempered"])
@pytest.mark.parametrize("C", [9, 16])
@pytest.mark.parametrize("L", [1, 3])
def test_emulation_matches_plain_and_jax_at_bitseq_width(L, C, temp):
    # 11 lanes: a full tile and a partial one
    inp = _inputs(100 * L + C, 11, L, C, **BITSEQ)
    _check_against_plain(inp, BITSEQ["H"], temp=temp, jax=True)


def test_ragged_actions_over_eight_ranks():
    # A = 203: ranks of 28 columns and a last one of 7; D = 48 gives the
    # last two ranks no proj / ff2 columns and H = 6 two ranks no head
    assert [split_cols(203, r) for r in range(RANKS)][-1] == (196, 203)
    inp = _inputs(5, 5, 2, 9, 48, 6, 80, 203)
    _check_against_plain(inp, 6, jax=True)


def _planted(seed=3, B=4):
    return _inputs(seed, B, 2, 16, **BITSEQ)


def test_planted_tie_across_two_slices_takes_the_lowest_index():
    inp = _planted()
    A = BITSEQ["A"]
    i, j = 5, split_cols(A, 1)[0] + 7          # rank 0 and rank 1
    for arr in (inp["w_out"],):
        arr[:, j] = arr[:, i]
    inp["b_out"][j] = inp["b_out"][i]
    inp["mask"][:, [i, j]] = True
    inp["gumbel"][:, [i, j]] = 40.0               # far above every other
    got = _check_against_plain(inp, BITSEQ["H"])
    assert (got[0] == i).all()


def test_a_slice_with_every_action_masked_never_wins():
    inp = _planted(seed=4)
    j0, j1 = split_cols(BITSEQ["A"], 2)
    inp["mask"][:, j0:j1] = False
    inp["gumbel"][:, j0:j1] = 80.0                # would win if legal
    got = _check_against_plain(inp, BITSEQ["H"])
    assert ((got[0] < j0) | (got[0] >= j1)).all()


def test_a_row_with_one_legal_action():
    inp = _planted(seed=5)
    inp["mask"][:] = False
    inp["mask"][np.arange(4), [3, 700, 2000, 3839]] = True
    got = _check_against_plain(inp, BITSEQ["H"])
    assert got[0].tolist() == [3, 700, 2000, 3839]
    assert torch.all(got[1] == 0.0)


@pytest.mark.parametrize("tile", [1, 4, 8])
def test_a_lane_is_bitwise_the_same_beside_any_neighbours(tile):
    inp = _inputs(7, 16, 2, 16, **BITSEQ)
    args = _args(inp)
    full = emulate_step(*args, num_heads=8)
    lane = 9
    others = [b for b in range(16) if b != lane]
    for first in (True, False):
        nbrs = (others[:tile - 1] if first else others[1 - tile:]) \
            if tile > 1 else []
        order = [lane] + nbrs if first else nbrs + [lane]
        pos = order.index(lane)
        idx = torch.tensor(order)
        sub = list(args)
        for k in (1, 4, 5, 6, 7, 10):        # per-lane operands
            sub[k] = args[k][idx]
        sub[2], sub[3] = args[2][:, idx], args[3][:, idx]    # caches
        got = emulate_step(*sub, num_heads=8)
        assert got[0][pos] == full[0][lane]
        assert torch.equal(got[1][pos], full[1][lane])
        assert torch.equal(got[2][pos], full[2][lane])
        assert torch.equal(got[3][:, pos], full[3][:, lane])
        assert torch.equal(got[4][:, pos], full[4][:, lane])


def test_the_ml_plus_g_shortcut_picks_another_action():
    """Two legal actions, every other masked, logits set by the bias (so
    the plain version and the kernel form the same ml and lse): search the
    second one's noise near the tie for a value where ml + g and
    (ml - lse) + g order the two differently."""
    inp = _planted(seed=6, B=1)
    i, j = 100, 2500
    inp["w_out"][:, [i, j]] = 0.0
    inp["b_out"][[i, j]] = np.float32([1.3, 7.1])
    inp["mask"][:] = False
    inp["mask"][0, [i, j]] = True
    inp["temp"][:] = 1.0
    inp["gumbel"][0, i] = np.float32(3.0)
    args = _args(inp)
    y = emulate_step(*args, num_heads=8)[2]
    lse = readout_sample(y, args[8], args[9], args[10], args[7], args[6])[2]
    lse = np.float32(lse.item())
    ml_i, ml_j = inp["b_out"][i], inp["b_out"][j]
    target = (ml_i - lse) + inp["gumbel"][0, i] - (ml_j - lse)
    found = None
    g = np.float32(target)
    for step in range(-64, 65):
        gj = np.float32(g + np.float32(step) * np.spacing(g))
        full = ((ml_i - lse) + inp["gumbel"][0, i], (ml_j - lse) + gj)
        short = (ml_i + inp["gumbel"][0, i], ml_j + gj)
        if (full[1] > full[0]) != (short[1] > short[0]):
            found = gj
            break
    assert found is not None
    inp["gumbel"][0, j] = found
    args = _args(inp)
    got = emulate_step(*args, num_heads=8)
    want = ref_decode_step(*args, num_heads=8)
    assert got[0].item() == want[0].item()
    short = readout_sample(got[2], args[8], args[9], args[10], args[7],
                           args[6], shortcut=True)
    assert {got[0].item(), short[0].item()} == {i, j}
