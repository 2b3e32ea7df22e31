"""The arithmetic of the SubTB kernels' centred decayed scan, emulated on the CPU.

``subtb_loss.cu`` computes the SubTB(lambda) loss and its gradient in O(T):
every state is shifted by the trajectory's phi_0, and each state's prefix
(and, for the gradient, suffix) is a segment summary (W, M, Q): decayed
weight, weighted mean, weighted sum of squared deviations, merged by
Chan's rule.  :func:`emulate` repeats the kernel's decomposition in fp32
torch: where T+1 <= 32 a warp per trajectory (lane k holds state k - 1,
a 5-round shuffle scan); above that a block of ``block_threads(T+1)``
threads, each folding a run of min(ceil((n+1) / threads), kRun) states
serially, a warp scan over the runs, a warp scan over the warps' totals,
a carry from tile to tile past ``kRun`` states a thread, and a walk of each
run from its prefix (the gradient: a pass from the right, then one from
the left); sums as xor butterflies and the warps' sums in order.
``kRun``, ``kMaxThreads`` come from the source.  The kernel divides in the
merge with ``__fdividef`` (2 ulp) and takes 1 / (W + 1) from
``rcp.approx`` (1 ulp); the emulation divides exactly.

It is held against a float64 pair form (O(T^2), chunked) at ``TOL`` = 1e-4,
``chip_smoke.py``'s tolerance, for the loss (relative) and the gradient
(its largest error over its largest entry), on the inputs that break the
other forms: potentials N(0, 1) or a random walk, offset by 1e3 (log Z
alone sets that level), at (3, 7000, 0.999), lambda = 1, and lengths 0
and 1.  Two cases document the forms the kernel does not take: JAX's
expanded prefix recurrence ``_subtb_prefix`` (S2 - 2 phi S1 + phi^2 W,
float32) misses the loss bar by orders at that offset, and the centred
form without the shift misses the gradient bar (folded serially at an
offset of 1e3, in the kernel's tree at 1e4).  Inputs are drawn with
numpy from a seed.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.objectives import _subtb_prefix as jax_prefix  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_subtb, ref_subtb_backward  # noqa: E402

torch.set_num_threads(2)

#: chip_smoke.py's tolerance for the kernel against its plain version
TOL = 1e-4
F32 = torch.float32
_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
        / "csrc" / "subtb_loss.cu").read_text()
RUN = int(re.search(r"constexpr int kRun = (\d+);", _SRC).group(1))
MAX_THREADS = int(re.search(r"constexpr int kMaxThreads = (\d+);",
                            _SRC).group(1))
LANES = torch.arange(32)


def block_threads(T1):
    """The block layout's threads (``block_threads`` in the source)."""
    return 32 * min(-(-T1 // (32 * RUN)), MAX_THREADS // 32)


# -- the kernel's arithmetic --------------------------------------------------------

def lam_pow(x, log2_lam):
    """lam^x as exp2f(x log2 lam)."""
    return torch.exp2(torch.as_tensor(x, dtype=F32) * log2_lam)


def merge(a, b, decay):
    """Segment a then b (tuples (W, M, Q) of tensors), decay =
    lam^(length of b)."""
    wa = a[0] * decay
    w = wa + b[0]
    r = torch.where(w > 0, b[0] / torch.where(w > 0, w, 1), 0)
    d = b[1] - a[1]
    return (w, a[1] + d * r, a[2] * decay + b[2] + d * d * wa * r)


def append(s, x, lam):
    """s followed by one state x, decayed past it."""
    w1 = s[0] + 1
    r = 1 / w1
    d = x - s[1]
    return (lam * w1, s[1] + d * r, lam * (s[2] + d * d * s[0] * r))


def where(c, a, b):
    return tuple(torch.where(c, u, v) for u, v in zip(a, b))


def empty(shape):
    return tuple(torch.zeros(shape, dtype=F32) for _ in range(3))


def shift(s, o, right):
    """``__shfl_up_sync`` (right=False) / ``__shfl_down_sync`` by o along
    the last dim (lanes out of range keep their own value)."""
    idx = (LANES + o).clamp(max=31) if right else (LANES - o).clamp(min=0)
    return tuple(u[..., idx] for u in s)


def warp_scan(s, span, log2_lam, right=False):
    """Inclusive scan over the last dim (32 lanes), left to right or right
    to left, each element ``span`` states long."""
    for o in (1, 2, 4, 8, 16):
        c = merge(shift(s, o, right), s, lam_pow(o * span, log2_lam))
        s = where(LANES + o < 32 if right else LANES >= o, c, s)
    return s


def warp_sum(v):
    """xor butterfly over the last dim; every lane ends with the sum."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ o]
    return v


def block_sum(v):
    """(warps, 32) -> the warp butterflies, then a butterfly over the
    warps' sums (padded to 32 with zeros)."""
    v = warp_sum(v)[:, 0]
    if v.shape[0] == 1:
        return v[0]
    return warp_sum(torch.nn.functional.pad(v, (0, 32 - v.shape[0])))[0]


def _warp_layout(psi, n, lam, log2_lam, g):
    """T+1 <= 32: psi (B, 32) shifted potentials (0 past n), n (B, 1)."""
    on = LANES <= n
    none = empty(psi.shape)
    single = lambda x: (torch.full_like(x, lam), x, torch.zeros_like(x))
    left = where((LANES >= 1) & on, single(shift((psi,), 1, False)[0]), none)
    left = warp_scan(left, 1, log2_lam)
    den = warp_sum(torch.where(on, left[0], 0))[:, 0]
    if g is None:
        d = psi - left[1]
        num = warp_sum(torch.where(on, left[2] + left[0] * d * d, 0))[:, 0]
        return num / torch.clamp(den, min=1e-9)
    right = where(LANES + 1 <= n, single(shift((psi,), 1, True)[0]), none)
    right = warp_scan(right, 1, log2_lam, right=True)
    scale = 2 * g / torch.clamp(den, min=1e-9)
    v = left[0] * (psi - left[1]) + right[0] * (psi - right[1])
    return torch.where(on, scale[:, None] * v, 0)


def _block_scan(s, run, log2_lam, right):
    """One direction's scan over the runs, as ``block_scan`` forms it:
    (warps, 32) run summaries -> each run's exclusive prefix (suffix where
    ``right``) and the tile's total."""
    nw = s[0].shape[0]
    inc = warp_scan(s, run, log2_lam, right)
    edge = 0 if right else 31
    ex = where(LANES == 31 - edge, empty(s[0].shape), shift(inc, 1, right))
    if nw == 1:
        return ex, tuple(u[0, edge] for u in inc)
    totals = tuple(u[:, edge] for u in inc)                    # (warps,)
    padded = where(LANES < nw, tuple(
        torch.nn.functional.pad(u, (0, 32 - nw)) for u in totals),
        empty((32,)))
    scanned = warp_scan(padded, 32 * run, log2_lam, right)
    tile = tuple(u[0 if right else nw - 1] for u in scanned)
    w = torch.arange(nw)
    src = (w + 1).clamp(max=31) if right else (w - 1).clamp(min=0)
    outer = where((w + 1 < nw)[:, None] if right else (w > 0)[:, None],
                  tuple(u[src][:, None].expand(nw, 32) for u in scanned),
                  empty((nw, 32)))
    inner_span = (31 - LANES) if right else LANES
    return merge(outer, ex, lam_pow(inner_span * run, log2_lam)), tile


def _block_layout(psi, n, lam, log2_lam, g):
    """T+1 > 32: one trajectory, psi (T+1,) shifted potentials.  Tiles of
    ``run * threads`` states, runs of ``run`` = min(ceil((n+1) / threads),
    kRun) states, a carry from tile to tile; the gradient takes a pass
    from the right (the right halves, den = sum of W^R), then one from the
    left."""
    T1 = psi.shape[0]
    nt = block_threads(T1)
    nw = nt // 32
    run = min((n + nt) // nt, RUN)
    tile = run * nt
    tid = torch.arange(nt).reshape(nw, 32)
    starts = list(range(0, n + 1, tile))
    out = torch.zeros(T1, dtype=F32)
    num = torch.zeros((nw, 32), dtype=F32)
    den = torch.zeros((nw, 32), dtype=F32)

    def tile_run(t0):
        j0 = torch.clamp(t0 + tid * run, max=n + 1)
        j1 = torch.clamp(j0 + run, max=n + 1)
        on = [j0 + i < j1 for i in range(run)]
        x = [torch.where(on[i], psi[(j0 + i).clamp(max=T1 - 1)], 0)
             for i in range(run)]
        return j0, j1, on, x

    def fold(on, x, order):
        s = empty((nw, 32))
        for i in order:
            s = where(on[i], append(s, x[i], lam), s)
        return s

    if g is not None:
        carry = empty(())
        for t0 in reversed(starts):
            j0, j1, on, x = tile_run(t0)
            end = min(t0 + tile, n + 1)
            s, total = _block_scan(fold(on, x, reversed(range(run))), run,
                                   log2_lam, right=True)
            s = merge(carry, s, lam_pow(end - j1, log2_lam))
            carry = merge(carry, total, lam_pow(end - t0, log2_lam))
            for i in reversed(range(run)):
                out[(j0 + i)[on[i]]] = (s[0] * (x[i] - s[1]))[on[i]]
                den = torch.where(on[i], den + s[0], den)
                s = where(on[i], append(s, x[i], lam), s)
        scale = 2 * g / torch.clamp(block_sum(den), min=1e-9)
    carry = empty(())
    for t0 in starts:
        j0, j1, on, x = tile_run(t0)
        s, total = _block_scan(fold(on, x, range(run)), run, log2_lam,
                               right=False)
        s = merge(carry, s, lam_pow(j0 - t0, log2_lam))
        carry = merge(carry, total, lam_pow(tile, log2_lam))
        for i in range(run):
            d = x[i] - s[1]
            if g is None:
                num = torch.where(on[i], num + (s[2] + s[0] * d * d), num)
                den = torch.where(on[i], den + s[0], den)
            else:
                j = (j0 + i)[on[i]]
                out[j] = scale * (out[j] + (s[0] * d)[on[i]])
            s = where(on[i], append(s, x[i], lam), s)
    if g is None:
        return block_sum(num) / torch.clamp(block_sum(den), min=1e-9)
    return out


def emulate(phi, length, lam, g=None, shifted=True):
    """The kernel's loss (g None) or gradient for cotangent g, in fp32:
    phi (B, T+1) float32, length (B,) int."""
    phi = torch.as_tensor(phi, dtype=F32)
    length = torch.as_tensor(length).long()
    B, T1 = phi.shape
    lam32 = torch.tensor(lam, dtype=F32)
    log2_lam = torch.log2(lam32)
    g = None if g is None else torch.as_tensor(g, dtype=F32)
    psi = phi - phi[:, :1] if shifted else phi.clone()
    if T1 <= 32:
        on = torch.arange(T1)[None, :] <= length[:, None]
        full = torch.nn.functional.pad(torch.where(on, psi, 0), (0, 32 - T1))
        out = _warp_layout(full, length[:, None], lam32, log2_lam, g)
        return out if g is None else out[:, :T1]
    outs = [_block_layout(psi[b], int(length[b]), lam32, log2_lam,
                          None if g is None else g[b]) for b in range(B)]
    return torch.stack(outs)


# -- float64 pair form and the inputs -----------------------------------------------

def pairs64(phi, length, lam, g, chunk=512):
    """(loss, gradient) from the pair sums in float64, rows in chunks."""
    phi = np.asarray(phi, np.float64)
    B, T1 = phi.shape
    loss, grad = np.zeros(B), np.zeros((B, T1))
    for b in range(B):
        n = int(length[b])
        p = phi[b, :n + 1]
        idx = np.arange(n + 1)
        num = den = 0.0
        for i0 in range(0, n + 1, chunk):
            i = idx[i0:i0 + chunk, None]
            w = float(lam) ** np.abs(i - idx[None, :]).astype(np.float64)
            w[i == idx[None, :]] = 0.0
            resid = p[i0:i0 + chunk, None] - p[None, :]
            num += 0.5 * float((w * resid * resid).sum())
            den += 0.5 * float(w.sum())
            grad[b, i0:i0 + len(i)] = (w * resid).sum(1)
        den = max(den, 1e-9)
        loss[b] = num / den
        grad[b] *= 2.0 * float(g[b]) / den
    return loss, grad


def inputs(B, T1, kind, offset, seed, lengths=None):
    """phi (B, T+1) float32 (N(0,1) or a random walk, plus offset),
    lengths (B,) int32 starting T, 0, 1 unless given, and a cotangent."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(B, T1)
    phi = (np.cumsum(steps, axis=1) if kind == "walk" else steps) + offset
    length = (rng.randint(0, T1, size=B) if lengths is None
              else np.array(lengths))
    if lengths is None:
        length[:3] = [T1 - 1, 0, 1][:B]
    g = rng.uniform(0.5, 2.0, size=B) * rng.choice([-1.0, 1.0], size=B)
    return (phi.astype(np.float32), length.astype(np.int32),
            g.astype(np.float32))


def loss_rel_err(got, want, length):
    got = np.asarray(got, np.float64)
    on = length > 0
    assert np.all(got[~on] == 0.0)                 # n = 0: exactly 0
    return float(np.max(np.abs(got[on] - want[on]) / np.abs(want[on])))


def grad_err_over_scale(got, want):
    """The largest error over the largest entry, trajectory by trajectory
    (a short trajectory's large entries would hide a long one's errors),
    the worst of them; rows whose gradient is all 0 must be exactly 0."""
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max(1)
    assert np.all(got[scale == 0] == 0.0)
    live = scale > 0
    return float((np.abs(got - want).max(1)[live] / scale[live]).max())


#: (B, T+1, lambda, kind, offset, lengths): the inputs that break the other
#: forms, two tiles of the block layout, the main path's shape, and short
#: trajectories in the block layout
CASES = {
    "7000-0.999-normal+1e3": (3, 7000, 0.999, "normal", 1e3, None),
    "7000-0.999-walk+1e3": (3, 7000, 0.999, "walk", 1e3, None),
    "7000-1.0-normal+1e3": (3, 7000, 1.0, "normal", 1e3, None),
    "7000-0.999-ragged": (4, 7000, 0.999, "walk", 1e3, [3001, 6998, 40, 1]),
    "20000-0.999-tiles": (2, 20000, 0.999, "walk", 1e3, [19999, 8192]),
    "30-0.9-normal+1e3": (16, 30, 0.9, "normal", 1e3, None),
    "30-1.0-walk+1e3": (16, 30, 1.0, "walk", 1e3, None),
    "78-0.9-walk": (5, 78, 0.9, "walk", 0.0, None),
    "33-0.5-normal": (4, 33, 0.5, "normal", 0.0, [32, 0, 1, 31]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_matches_float64_pairs(case):
    B, T1, lam, kind, offset, lengths = CASES[case]
    phi, length, g = inputs(B, T1, kind, offset, seed=T1 + len(case),
                            lengths=lengths)
    want_loss, want_grad = pairs64(phi, length, lam, g)
    got_loss = emulate(phi, length, lam).numpy()
    got_grad = emulate(phi, length, lam, g).numpy()
    assert loss_rel_err(got_loss, want_loss, length) <= TOL
    assert grad_err_over_scale(got_grad, want_grad) <= TOL
    # past n the gradient is exactly 0
    past = np.arange(T1)[None, :] > length[:, None]
    assert np.all(got_grad[past] == 0.0)


@pytest.mark.parametrize("B,T1,lam", [(4, 16, 0.9), (5, 30, 0.99),
                                      (3, 100, 0.8), (2, 64, 0.99),
                                      (3, 300, 0.9), (1, 7, 0.5)])
def test_scan_matches_the_plain_version(B, T1, lam):
    """Both layouts against the plain fp32 versions the card's check uses
    (``ref_subtb``, ``ref_subtb_backward``), at the shapes of
    ``tests/test_torch_subtb.py``."""
    phi, length, g = inputs(B, T1, "normal", 0.0, seed=B * T1)
    t_phi, t_len, t_g = map(torch.from_numpy, (phi, length, g))
    want = ref_subtb(t_phi, t_len, lam).numpy().astype(np.float64)
    assert loss_rel_err(emulate(phi, length, lam).numpy(), want,
                        length) <= TOL
    want_grad = ref_subtb_backward(t_phi, t_len, lam, t_g).numpy()
    assert grad_err_over_scale(emulate(phi, length, lam, g).numpy(),
                               want_grad.astype(np.float64)) <= TOL


def test_block_layout_sizes_runs_from_the_source():
    """The block layout's threads and runs at the shapes the card checks:
    about ``kRun`` states a thread at full length, one warp up to 256
    states, at most ``kMaxThreads``; a tile holds ``kRun`` states a
    thread."""
    assert [block_threads(t) for t in (33, 78, 256, 257, 7000, 10 ** 6)] \
        == [32, 32, 32, 64, 896, MAX_THREADS]
    nt = block_threads(7000)
    assert (6999 + nt) // nt == RUN           # one tile of 896 runs of 8
    # past kRun * kMaxThreads states a trajectory takes several tiles
    assert RUN * MAX_THREADS < 20000


def test_jax_expanded_prefix_fails_at_an_offset():
    """A documented fault of the reference: JAX's O(T) recurrence
    (``repro.core.objectives._subtb_prefix``: S2 - 2 phi S1 + phi^2 W) in
    float32 cancels catastrophically once phi carries a common offset of
    1e3, where the kernel's centred, shifted scan holds."""
    B, T1, lam, kind, offset, _ = CASES["7000-0.999-normal+1e3"]
    phi, length, g = inputs(B, T1, kind, offset, seed=7)
    want, _ = pairs64(phi, length, lam, np.ones(B, np.float32))
    got = np.asarray(jax_prefix(jnp.asarray(phi.T), jnp.asarray(length),
                                lam))
    assert loss_rel_err(got, want, length) > 100 * TOL
    assert loss_rel_err(emulate(phi, length, lam).numpy(), want,
                        length) <= TOL


def serial_gradient(phi, length, lam, g, shifted):
    """The centred form folded by one thread over the whole trajectory
    (no runs, no tree), in numpy float32: each state's left and right
    (W, M) by :func:`append`, then the gradient."""
    f = np.float32
    lam = f(lam)
    out = np.zeros(phi.shape, f)
    for b in range(phi.shape[0]):
        n = int(length[b])
        psi = phi[b, :n + 1] - (phi[b, 0] if shifted else f(0))
        left, right = [], [None] * (n + 1)
        s = (f(0), f(0), f(0))
        for k in range(n + 1):
            left.append(s)
            s = append(s, psi[k], lam)
        s = (f(0), f(0), f(0))
        for k in range(n, -1, -1):
            right[k] = s
            s = append(s, psi[k], lam)
        den = f(0)
        for w, _, _ in left:
            den = den + w
        scale = f(2) * g[b] / max(den, f(1e-9))
        for k in range(n + 1):
            (wl, ml, _), (wr, mr, _) = left[k], right[k]
            out[b, k] = scale * (wl * (psi[k] - ml) + wr * (psi[k] - mr))
    return out


@pytest.mark.parametrize("form,offset", [("serial", 1e3), ("tree", 1e4)])
def test_unshifted_centred_scan_misses_the_gradient_bar(form, offset):
    """Without the shift by phi_0 the centred form's means sit near the
    offset, each rounded to ~offset * 6e-8, and the gradient's
    W (phi - M) terms carry that past the bar: folded serially at an offset
    of 1e3, and in the kernel's own tree of short runs at 1e4.  Shifted,
    both hold."""
    B, T1, lam, kind, _, _ = CASES["7000-0.999-normal+1e3"]
    phi, length, g = inputs(B, T1, kind, offset, seed=7)
    _, want = pairs64(phi, length, lam, g)
    if form == "serial":
        got = {sh: serial_gradient(phi, length, lam, g, sh)
               for sh in (False, True)}
    else:
        got = {sh: emulate(phi, length, lam, g, shifted=sh).numpy()
               for sh in (False, True)}
    assert grad_err_over_scale(got[False], want) > TOL
    assert grad_err_over_scale(got[True], want) <= TOL


def test_wrapper_on_cpu_is_the_plain_version_at_an_offset():
    """``ops.subtb_loss`` and ``ops.subtb_loss_backward`` on CPU tensors
    (their plain versions) hold the float64 pair form at the offset
    inputs of the card's new rows, so the card's check compares the kernel
    with a yardstick that is itself right there."""
    phi, length, g = inputs(16, 30, "normal", 1e3, seed=3)
    want_loss, want_grad = pairs64(phi, length, 0.9, g)
    t_phi, t_len, t_g = map(torch.from_numpy, (phi, length, g))
    assert loss_rel_err(ops.subtb_loss(t_phi, t_len, 0.9).numpy(),
                        want_loss, length) <= TOL
    assert grad_err_over_scale(
        ops.subtb_loss_backward(t_phi, t_len, t_g, 0.9).numpy(),
        want_grad) <= TOL
    assert math.isfinite(float(want_loss.sum()))
