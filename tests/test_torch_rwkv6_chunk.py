"""The arithmetic of the chunk-parallel RWKV6 scan kernel, emulated on the CPU.

``rwkv6_chunk.cu`` (the scan's ``"chunk"`` route, ``ops.scan_route``) cuts
the sequence into chunks of 64 steps and each chunk into sub-chunks of 16.
Every decay factor it forms is ``exp2`` of a difference of in-chunk
log2-cumsums that is <= 0, taken against a reference point: the chunk's
start for ``r S_in``, the start of sub-chunk I for the scores of I against
an earlier sub-chunk J, the chunk's end for the chunk's own state; the
16 x 16 diagonal blocks are summed on the fp32 cores, each column's k_s
carried down the rows times one clipped decay a row.  Products run on
bf16 tensor cores: an fp32 operand goes in as two
bf16 parts, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and a product is
``hi hi + hi lo + lo hi`` (r, k, v are bf16 already and go in whole), the
sums in fp32.  The chunks' states are carried across chunks by a short
sequential pass.  :func:`chunk_scan` repeats that arithmetic in plain
torch and is held entry by entry, under the check ``chip_smoke.py`` holds
the kernel to (``_held``: |err| <= 2^-7 |want| + 1e-3 rms(want) for the
bf16 output, one bf16 ulp; 1e-4 |want| + 1e-4 rms(want) for the fp32
state), against both packages' step recurrences at strong decays (where
JAX's chunk form, which divides by the running product clamped at 1e-30,
parts from them) and against JAX's chunk form at mild decays (where its
clamp does not engage).  The two variants the kernel avoids fail the same
check: dividing by the running product, and one bf16 rounding of an fp32
operand.  Inputs are drawn with numpy from a seed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_rwkv6 as jax_ref  # noqa: E402
from repro.models.layers import chunked_linear_attention as jax_layer  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_rwkv6  # noqa: E402

torch.set_num_threads(2)

CHUNK, SUB = 64, 16
F32 = torch.float32
#: (H, Dk, Dv, bonus): Hymba's SSM heads (25 cut to 3; state 16, head 64,
#: no u) and RWKV6's (64 x 64 with u)
HYMBA = (3, 16, 64, False)
RWKV = (2, 64, 64, True)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(x):
    return x.to(torch.bfloat16).to(F32)


def _product(a, b, split, b_exact=False):
    """``a @ b`` as the kernel's ``mma.sync`` takes it: each fp32 operand
    as bf16 parts (``hi``, and with ``split`` ``lo = bf16(x - hi)``), an
    operand that is bf16 already (``b_exact``) whole; the products of parts
    are exact in fp32 and summed in fp32, ``lo lo`` left out."""
    a_hi = _bf16(a)
    b_hi = b if b_exact else _bf16(b)
    out = a_hi @ b_hi
    if split:
        out = out + _bf16(a - a_hi) @ b_hi
        if not b_exact:
            out = out + a_hi @ _bf16(b - b_hi)
    return out


def chunk_scan(r, k, v, w, u=None, state=None, *, split=True, divide=False):
    """The wkv recurrence as ``rwkv6_chunk.cu`` computes it.  r/k/v: (B, T,
    H, Dk/Dv) bf16; w: (B, T, H, Dk) fp32, clipped to [1e-8, 1]; u: (H, Dk)
    or None; state: (B, H, Dk, Dv) fp32 or None.  Returns ``(o in bf16,
    final state fp32)``.  ``split=False`` rounds each fp32 operand once to
    bf16; ``divide=True`` forms the scores as JAX's chunk form does,
    ``r W_excl`` against ``k / max(W_incl, 1e-30)`` from the chunk's start
    (in fp32, no tensor-core rounding)."""
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    n = -(-T // CHUNK)
    pad = (0, 0, 0, 0, 0, n * CHUNK - T)
    pf = torch.nn.functional.pad

    def chunks(x, value=0.0):                 # (B, H, n, CHUNK, D)
        return pf(x, pad, value=value).reshape(
            B, n, CHUNK, H, -1).permute(0, 3, 1, 2, 4)

    rc, kc, vc = (chunks(x.to(F32)) for x in (r, k, v))
    # clipped decays and their log2; padded steps decay by 1 (log 0)
    wc = chunks(w.to(F32).clamp(1e-8, 1.0), value=1.0)
    lw = torch.log2(wc)
    # L[..., t, :] = sum_{s < t} log2 w_s inside the chunk, t = 0..CHUNK
    L = torch.cat([torch.zeros_like(lw[..., :1, :]), lw.cumsum(3)], 3)
    uf = None if u is None else u.to(F32)[None, :, None, None, :]

    # pass 1: each chunk's own state (its steps from zero) and its decay
    decay = torch.exp2(L[..., CHUNK, :])                     # (B, H, n, Dk)
    k_last = kc * torch.exp2(L[..., CHUNK:, :] - L[..., 1:, :])
    dS = _product(k_last.transpose(-1, -2), vc, split, b_exact=True)
    # pass 2: the state entering each chunk, in order of chunks
    S = (torch.zeros(B, H, Dk, Dv) if state is None else state.to(F32))
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = torch.addcmul(dS[:, :, c], decay[:, :, c, :, None], S)
    s_in = torch.stack(s_in, 2)                              # (B,H,n,Dk,Dv)

    # pass 3: the output, sub-chunk by sub-chunk
    o = []
    for i in range(CHUNK // SUB):
        t0 = i * SUB
        rt, Lt = rc[..., t0:t0 + SUB, :], L[..., t0:t0 + SUB, :]
        if divide:
            q = rt * torch.exp2(Lt)
            kd = kc[..., :t0 + SUB, :] / torch.exp2(
                L[..., 1:t0 + SUB + 1, :]).clamp_min(1e-30)
            A = q @ kd.transpose(-1, -2)
            s_idx = torch.arange(t0 + SUB)[None, :]
            t_idx = (t0 + torch.arange(SUB))[:, None]
            A = torch.where(s_idx < t_idx, A, 0.0)
            if uf is not None:
                bonus = (rt * uf * kc[..., t0:t0 + SUB, :]).sum(-1)
                A = A + bonus[..., None] * (s_idx == t_idx)
            o.append(A @ vc[..., :t0 + SUB, :] + q @ s_in)
            continue
        ref = L[..., t0:t0 + 1, :]
        q = rt * torch.exp2(Lt - ref)                        # exponents <= 0
        blocks = []
        for j in range(i):
            s0 = j * SUB
            kap = kc[..., s0:s0 + SUB, :] * torch.exp2(
                ref - L[..., s0 + 1:s0 + SUB + 1, :])        # exponents <= 0
            blocks.append(_product(q, kap.transpose(-1, -2), split))
        # the diagonal block on the fp32 cores: down each column s, k_s
        # times the clipped decays w_{s+1} ... w_{t-1}, one factor a row
        wt = wc[..., t0:t0 + SUB, :]
        ks = kc[..., t0:t0 + SUB, :]             # (.., column s, Dk)
        kp = torch.zeros_like(ks)
        cols = torch.arange(SUB)[:, None]
        rows = [torch.zeros_like(ks[..., 0])]
        for tl in range(1, SUB):
            kp = torch.where(cols == tl - 1, ks, kp * wt[..., tl - 1:tl, :])
            rows.append((rt[..., tl:tl + 1, :] * kp).sum(-1))
        diag = torch.stack(rows, -2)             # (.., row t, column s)
        if uf is not None:
            bonus = (rt * uf * kc[..., t0:t0 + SUB, :]).sum(-1)
            diag = diag + torch.diag_embed(bonus)
        A = torch.cat(blocks + [diag], -1)                  # (.., SUB, t0+SUB)
        o.append(_product(A, vc[..., :t0 + SUB, :], split, b_exact=True)
                 + _product(rt * torch.exp2(Lt), s_in, split))
    o = torch.cat(o, 3).permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, Dv)
    return o[:, :T].to(r.dtype), S


def _draw(B, T, H, Dk, Dv, seed, *, bonus, state, decay):
    """r, k, v ~ N(0, 1) in bf16; u ~ 0.1 N(0, 1); a state ~ N(0, 1); w by
    ``decay``: "mild" 0.35 + 0.6 sigmoid(N(0, 1)) (the JAX tests' draw),
    "0.2" constant (1e-30 passed in 43 steps), "strong" log-uniform in
    [1e-8, 0.3] (0.3^64 < 1e-33)."""
    rng = np.random.RandomState(seed)
    r, k = (rng.randn(B, T, H, Dk).astype(np.float32) for _ in range(2))
    v = rng.randn(B, T, H, Dv).astype(np.float32)
    if decay == "mild":
        w = 0.35 + 0.6 / (1 + np.exp(-rng.randn(B, T, H, Dk)))
    elif decay == "0.2":
        w = np.full((B, T, H, Dk), 0.2)
    else:
        w = np.exp(rng.uniform(np.log(1e-8), np.log(0.3), (B, T, H, Dk)))
    u = (0.1 * rng.randn(H, Dk)).astype(np.float32) if bonus else None
    s = rng.randn(B, H, Dk, Dv).astype(np.float32) if state else None
    # r, k, v rounded to bf16 once, so both packages see the same values
    r, k, v = (torch.from_numpy(x).to(torch.bfloat16).to(F32).numpy()
               for x in (r, k, v))
    return r, k, v, w.astype(np.float32), u, s


def _torch(r, k, v, w, u, s):
    bf = torch.bfloat16
    return (torch.from_numpy(r).to(bf), torch.from_numpy(k).to(bf),
            torch.from_numpy(v).to(bf), torch.from_numpy(w),
            None if u is None else torch.from_numpy(u),
            None if s is None else torch.from_numpy(s))


def _jax(r, k, v, w, u, s):
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v)]
            + [jnp.asarray(w), None if u is None else jnp.asarray(u),
               None if s is None else jnp.asarray(s)])


def _from_jax(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _excess(got, want):
    """Largest excess of o (bf16 rule) and of the state (fp32 rule)."""
    held = _chip_smoke()._held
    return (held(got[0], want[0], True)["excess"],
            held(got[1], want[1], False)["excess"])


#: (geometry, B, T, state): full chunks, T < 64, T not a multiple of 64
SHAPES = [(HYMBA, 2, 192, True), (HYMBA, 1, 50, False),
          (HYMBA, 2, 131, True), (RWKV, 1, 128, True), (RWKV, 2, 77, False)]


@pytest.mark.parametrize("decay", ["0.2", "strong"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_arithmetic_is_held_to_both_recurrences(shape, decay):
    (H, Dk, Dv, bonus), B, T, state = shape
    arrs = _draw(B, T, H, Dk, Dv, seed=T, bonus=bonus, state=state,
                 decay=decay)
    args = _torch(*arrs)
    got = chunk_scan(*args)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == F32
    assert max(_excess(got, ref_rwkv6(*args))) <= 1
    jo, js = jax_ref(*_jax(*arrs))
    assert max(_excess(got, (_from_jax(jo), _from_jax(js)))) <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_arithmetic_is_held_to_the_jax_chunk_form_at_mild_decay(
        shape):
    """Decays in [0.35, 0.95]: no chunk's product falls below 1e-30 (0.35^64
    = 1e-29 at the least), so JAX's model layer is right here, and it
    starts from the state as the port's kernel does."""
    (H, Dk, Dv, bonus), B, T, state = shape
    arrs = _draw(B, T, H, Dk, Dv, seed=T + 1, bonus=bonus, state=True,
                 decay="mild")
    args = _torch(*arrs)
    got = chunk_scan(*args)
    jargs = _jax(*arrs)
    jo, js = jax_layer(*jargs[:5], state=jargs[5], chunk=CHUNK)
    assert max(_excess(got, (_from_jax(jo), _from_jax(js)))) <= 1
    assert max(_excess(got, ref_rwkv6(*args))) <= 1


@pytest.mark.parametrize("geometry", [HYMBA, RWKV], ids=["hymba", "rwkv"])
def test_halves_chained_through_the_state_equal_the_whole(geometry):
    """Two calls split at a step that is not a chunk boundary, the second
    from the first's state, give the whole call's output and state."""
    H, Dk, Dv, bonus = geometry
    args = _torch(*_draw(1, 200, H, Dk, Dv, seed=5, bonus=bonus, state=True,
                         decay="strong"))
    o, S = chunk_scan(*args)
    o1, S1 = chunk_scan(*(x[:, :90] for x in args[:4]), args[4], args[5])
    o2, S2 = chunk_scan(*(x[:, 90:] for x in args[:4]), args[4], S1)
    assert max(_excess((torch.cat([o1, o2], 1), S2), (o, S))) <= 1


@pytest.mark.parametrize("geometry", [HYMBA, RWKV], ids=["hymba", "rwkv"])
def test_dividing_by_the_running_product_fails_at_strong_decay(geometry):
    """JAX's chunk form (``k / max(W_incl, 1e-30)``) on the same inputs,
    in fp32: far from the recurrence wherever a chunk's product passes
    1e-30 (o's excess 215 and 322 for the two geometries); the kernel's
    reference points are held (0.79 and 0.77)."""
    H, Dk, Dv, bonus = geometry
    args = _torch(*_draw(2, 128, H, Dk, Dv, seed=9, bonus=bonus, state=True,
                         decay="0.2"))
    want = ref_rwkv6(*args)
    assert _excess(chunk_scan(*args, divide=True), want)[0] > 100
    assert max(_excess(chunk_scan(*args), want)) <= 1


@pytest.mark.parametrize("geometry", [HYMBA, RWKV], ids=["hymba", "rwkv"])
def test_one_bf16_rounding_of_fp32_operands_fails_the_check(geometry):
    """Each fp32 operand of a product (the decayed r and k, the scores, the
    carried state) rounded once to bf16: outputs land more than one bf16
    ulp from the recurrence (o's excess 9.3 and 7.0 for the two
    geometries, the state's 49); the two-part split stays within one
    (0.79 and 0.72)."""
    H, Dk, Dv, bonus = geometry
    args = _torch(*_draw(2, 192, H, Dk, Dv, seed=10, bonus=bonus,
                         state=True, decay="mild"))
    want = ref_rwkv6(*args)
    assert _excess(chunk_scan(*args, split=False), want)[0] > 2
    assert max(_excess(chunk_scan(*args), want)) <= 1


@pytest.mark.parametrize("dtype,T,route", [
    (torch.bfloat16, 4096, "chunk"), (torch.bfloat16, 64, "chunk"),
    (torch.bfloat16, 63, "recurrence"), (torch.bfloat16, 1, "recurrence"),
    (torch.float32, 4096, "recurrence"), (torch.float32, 1, "recurrence")])
def test_route_rule(dtype, T, route):
    """``ops.scan_route``: the chunk kernel for bf16 at T >= 64, the
    recurrence for fp32 and short T; on CPU tensors neither runs, and no
    route counts a launch."""
    assert ops.scan_route(dtype, T) == route
    before = dict(ops.rwkv6_scan.route_launches)
    r = torch.zeros(1, T, 2, 16, dtype=dtype)
    w = torch.ones(1, T, 2, 16)
    o, S = ops.rwkv6_scan(r, r, torch.zeros(1, T, 2, 8, dtype=dtype), w)
    assert o.shape == (1, T, 2, 8) and S.shape == (1, 2, 16, 8)
    assert ops.rwkv6_scan.route_launches == before
