"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

Each function here computes what its kernel computes, in batched torch ops.
The CPU path of every wrapper in :mod:`repro_torch.kernels.ops` runs it, the
CPU tests hold it against ``repro.kernels.ref``, and ``chip_smoke.py`` holds
the kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from ..nn.core import gelu


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def ref_decode_step(w: Mapping[str, torch.Tensor], x_new: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, slot: torch.Tensor,
                    gumbel: torch.Tensor, action_mask: torch.Tensor,
                    w_out: torch.Tensor, b_out: torch.Tensor,
                    logit_temp: Optional[torch.Tensor] = None, *,
                    num_heads: int):
    """One fused cached-rollout step: cache append + latent-query decode +
    masked Gumbel-max sampling.  Functional: the caches are not modified.

    w: stacked decoder weights (``nn.transformer.decoder_stacked_weights``);
    x_new: (B, D); k/v_cache: (num_layers, B, C, D) merged-head layout;
    lengths/slot: (B,) int (``slot`` may be a scalar); gumbel: (B, A);
    action_mask: (B, A) nonzero = legal; w_out/b_out: (D, A)/(A,);
    logit_temp: optional (B,) logit scale (None = 1).
    Returns ``(action (B,) int32, log_pf (B,), y (B, D), new_k, new_v)``.
    """
    L, B, C, D = k_cache.shape
    hd = D // num_heads
    f32 = torch.float32
    dev = x_new.device
    x = x_new.to(f32)

    kv = torch.einsum("bd,lde->lbe", x, w["kv_w"].to(f32)) \
        + w["kv_b"].to(f32)[:, None]                        # (L, B, 2D)
    rows = torch.arange(B, device=dev)
    slot = torch.as_tensor(slot, device=dev).long().expand(B)
    new_k = k_cache.clone()
    new_v = v_cache.clone()
    new_k[:, rows, slot] = kv[..., :D].to(k_cache.dtype)
    new_v[:, rows, slot] = kv[..., D:].to(v_cache.dtype)

    live = (torch.arange(C, device=dev)[None, :]
            < (lengths.to(dev)[:, None] + 1))               # (B, C)
    h = w["q0"].to(f32)[None].expand(B, D)
    for l in range(L):
        g = _layernorm(h, w["ln1_scale"][l].to(f32), w["ln1_bias"][l].to(f32))
        q = g @ w["q_w"][l].to(f32) + w["q_b"][l].to(f32)
        qh = q.reshape(B, num_heads, hd)
        kl = new_k[l].to(f32).reshape(B, C, num_heads, hd)
        vl = new_v[l].to(f32).reshape(B, C, num_heads, hd)
        s = torch.einsum("bhd,bshd->bhs", qh, kl) / math.sqrt(hd)
        s = torch.where(live[:, None, :], s,
                        torch.tensor(-1e30, dtype=f32, device=dev))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", a, vl).reshape(B, D)
        h = h + o @ w["proj_w"][l].to(f32) + w["proj_b"][l].to(f32)
        g2 = _layernorm(h, w["ln2_scale"][l].to(f32),
                        w["ln2_bias"][l].to(f32))
        ff = gelu(g2 @ w["ff1_w"][l].to(f32) + w["ff1_b"][l].to(f32))
        h = h + ff @ w["ff2_w"][l].to(f32) + w["ff2_b"][l].to(f32)
    y = _layernorm(h, w["ln_f_scale"].to(f32), w["ln_f_bias"].to(f32))

    logits = y @ w_out.to(f32) + b_out.to(f32)
    if logit_temp is not None:
        logits = logits * logit_temp.to(f32)[:, None]
    neg = torch.tensor(torch.finfo(f32).min, dtype=f32, device=dev)
    ml = torch.where(action_mask != 0, logits, neg)
    logp = ml - torch.logsumexp(ml, dim=-1, keepdim=True)
    # torch.argmax, like jnp.argmax, resolves ties to the lowest index
    action = torch.argmax(logp + gumbel.to(f32), dim=-1)
    log_pf = torch.gather(logp, 1, action[:, None])[:, 0]
    return (action.to(torch.int32), log_pf, y.to(x_new.dtype), new_k,
            new_v)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: torch.Tensor) -> torch.Tensor:
    """Single-query attention against a KV cache (port of
    ``repro.kernels.ref.ref_decode_attention``).

    q: (B, H, D); k/v: (B, S, H, D); kv_valid: (B,) number of valid leading
    slots (slot s is attended iff ``s < kv_valid[b]``).  Returns (B, H, D);
    rows with ``kv_valid == 0`` are exact zeros (an empty attention sum,
    not a uniform average)."""
    S, D = k.shape[1], k.shape[3]
    f32 = torch.float32
    logits = torch.einsum("bhd,bshd->bhs", q.to(f32),
                          k.to(f32)) / math.sqrt(D)
    live = (torch.arange(S, device=q.device)[None, :]
            < kv_valid.to(q.device)[:, None])[:, None, :]    # (B, 1, S)
    logits = torch.where(live, logits, torch.tensor(-1e30, dtype=f32,
                                                    device=q.device))
    a = torch.where(live, torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bhs,bshd->bhd", a, v.to(f32)).to(q.dtype)


def _masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=torch.float32,
                       device=logits.device)
    return torch.where(mask != 0, logits.to(torch.float32), neg)


def ref_traj_logprob(logits: torch.Tensor, actions: torch.Tensor,
                     mask: torch.Tensor, valid: torch.Tensor):
    """Per-trajectory log-probability accumulation (port of
    ``repro.kernels.ref.ref_traj_logprob``).

    logits: (B, T, A); actions: (B, T) int; mask: (B, T, A) nonzero =
    legal; valid: (B, T) nonzero = live transition.  Returns
    ``(total (B,), per_step (B, T))`` with ``per_step[b, t] = valid *
    log_softmax(masked logits)[action]`` (masked logits at float32 min) and
    ``total = per_step.sum(-1)``."""
    ml = _masked_logits(logits, mask)
    logp = ml - torch.logsumexp(ml, dim=-1, keepdim=True)
    lpa = torch.gather(logp, -1, actions.long()[..., None])[..., 0]
    per_step = torch.where(valid != 0, lpa, 0.0)
    return per_step.sum(-1), per_step


def ref_traj_logprob_backward(logits: torch.Tensor, actions: torch.Tensor,
                              mask: torch.Tensor, valid: torch.Tensor,
                              g_total: torch.Tensor,
                              g_step: torch.Tensor) -> torch.Tensor:
    """The closed-form VJP of :func:`ref_traj_logprob` with respect to
    ``logits`` (port of ``repro.kernels.ops.traj_logprob``'s backward):
    ``(g_total[b] + g_step[b, t]) * valid * (onehot(action) - softmax)``,
    softmax over the masked logits.  Returns (B, T, A) float32."""
    p = torch.softmax(_masked_logits(logits, mask), dim=-1)
    onehot = torch.nn.functional.one_hot(actions.long(),
                                         logits.shape[-1]).to(torch.float32)
    coeff = (g_total.to(torch.float32)[:, None] + g_step.to(torch.float32)) \
        * (valid != 0)
    return coeff[..., None] * (onehot - p)


def _subtb_weights(T1: int, length: torch.Tensor, lam: float,
                   device: torch.device) -> torch.Tensor:
    """(B, T+1, T+1) pair weights: lam^(k-j) where j < k <= length[b],
    else 0."""
    f32 = torch.float32
    idx = torch.arange(T1, device=device)
    on = idx[None, :] <= length.to(device).long()[:, None]       # (B, T+1)
    pair = on[:, :, None] & on[:, None, :] & (idx[:, None] < idx[None, :])
    w = torch.tensor(lam, dtype=f32, device=device) ** \
        (idx[None, :] - idx[:, None]).to(f32)
    return torch.where(pair, w[None], torch.zeros((), dtype=f32,
                                                   device=device))


def ref_subtb(phi: torch.Tensor, length: torch.Tensor,
              lam: float) -> torch.Tensor:
    """Per-trajectory SubTB(lambda) loss from flow-corrected potentials,
    the dense pairwise form (port of ``repro.kernels.ref.ref_subtb``).

    phi: (B, T+1) with phi_t = log F(s_t) - cumsum(log_pf - log_pb);
    length: (B,) trajectory length n (states 0..n are on the trajectory).
    loss_b = sum_{0<=j<k<=n} lam^(k-j) (phi_j - phi_k)^2
             / max(sum lam^(k-j), 1e-9); 0 when n = 0."""
    B, T1 = phi.shape
    w = _subtb_weights(T1, length, lam, phi.device)
    resid = phi[:, :, None] - phi[:, None, :]
    num = (w * resid.square()).sum((1, 2))
    den = torch.clamp(w.sum((1, 2)), min=1e-9)
    return num / den


def ref_subtb_backward(phi: torch.Tensor, length: torch.Tensor, lam: float,
                       g: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`ref_subtb` with respect to ``phi`` for the
    cotangent ``g`` (B,), in closed form: for i <= n,
    ``g * 2 / max(den, 1e-9) * sum_{m<=n, m!=i} lam^|i-m| (phi_i - phi_m)``
    and 0 past n.  ``den`` does not depend on phi.  Returns (B, T+1)."""
    B, T1 = phi.shape
    w = _subtb_weights(T1, length, lam, phi.device)
    den = torch.clamp(w.sum((1, 2)), min=1e-9)
    sym = w + w.transpose(1, 2)                        # lam^|i-m|, i != m
    resid = phi[:, :, None] - phi[:, None, :]          # phi_i - phi_m
    return (2 * g.to(torch.float32) / den)[:, None] * (sym * resid).sum(-1)


def attention_mask(q_len: int, kv_size: int, *, causal: bool, window: int,
                   q_offset: int, kv_len: Optional[int],
                   device: torch.device) -> torch.Tensor:
    """(Sq, Skv) bool: query row i sits at position ``q_offset + i`` and key
    j at j; key j is attended iff ``j < kv_len`` (``Skv`` when None), and
    with ``causal`` ``j <= q position``, with ``window`` ``j > q position -
    window``."""
    qp = q_offset + torch.arange(q_len, device=device)[:, None]
    kp = torch.arange(kv_size, device=device)[None, :]
    mask = kp < (kv_size if kv_len is None else kv_len)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


def _attention_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                      window: int, q_offset: int, kv_len: Optional[int]):
    """The float32 scores ``q.k / sqrt(D)`` (B, H, Sq, Skv), query head h
    against kv head h // (H / KVH), masked to -1e30, and the (Sq, Skv)
    mask of :func:`attention_mask`."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    f32 = torch.float32
    kr = k.to(f32).repeat_interleave(H // KVH, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kr) / math.sqrt(D)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=f32,
                                                    device=q.device))
    return logits, mask


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """GQA attention in the dense O(Sq Skv) form (port of
    ``repro.kernels.ref.ref_flash_attention``).

    q: (B, Sq, H, D); k/v: (B, Skv, KVH, D) with H % KVH == 0 (query head h
    reads kv head h // (H / KVH)).  Mask as :func:`attention_mask`; scores
    ``q.k / sqrt(D)`` and the softmax in float32; the output in q's dtype.
    A query row that attends no key is zeros, as in the kernel (JAX's
    oracle averages every key there, its chunked layer the keys of the
    chunks it saw; no caller makes such a row: on the causal path every row
    attends its own position)."""
    H, KVH = q.shape[2], k.shape[2]
    logits, mask = _attention_scores(q, k, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    a = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    vr = v.to(torch.float32).repeat_interleave(H // KVH, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", a, vr).to(q.dtype)


def ref_flash_attention_lse(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0,
                            kv_len: Optional[int] = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its attended scaled scores, (B, H,
    Sq) float32, -inf for a row that attends no key: what the forward
    kernels write into ``lse`` for the backward pass."""
    logits, mask = _attention_scores(q, k, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.where(mask.any(-1), lse, float("-inf"))


def ref_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """The backward pass of :func:`ref_flash_attention` (q_offset 0, every
    key valid) in the dense form, the arithmetic of
    ``flash_attention_bwd.cu``: from the forward's output ``out`` (B, Sq,
    H, D) and row log-sum-exp ``lse`` (B, H, Sq) and the cotangent ``do``,
    ``P = exp(s - lse)`` on the attended keys (0 elsewhere), ``Delta =
    rowsum(do * out)``, ``dS = P (do.v - Delta)``; ``dq = dS k / sqrt(D)``,
    ``dk = dS^T q / sqrt(D)`` and ``dv = P^T do``, dk and dv summed over
    each kv head's group of query heads.  Everything in float32; returns
    ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    f32 = torch.float32
    logits, mask = _attention_scores(q, k, causal=causal, window=window,
                                     q_offset=0, kv_len=None)
    p = torch.where(mask, torch.exp(logits - lse.to(f32)[..., None]), 0.0)
    dof = do.to(f32)
    delta = (dof * out.to(f32)).sum(-1).permute(0, 2, 1)       # (B, H, Sq)
    kr = k.to(f32).repeat_interleave(G, dim=2)
    vr = v.to(f32).repeat_interleave(G, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f32)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, KVH, G, D).sum(3)
    dv = dv.reshape(B, Skv, KVH, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ref_rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: Optional[torch.Tensor] = None,
              state: Optional[torch.Tensor] = None):
    """The wkv recurrence step by step, in float32 (port of
    ``repro.kernels.ref.ref_rwkv6``, with an initial state).

    r/k/w: (B, T, H, Dk); v: (B, T, H, Dv); u: (H, Dk) or None; state:
    (B, H, Dk, Dv) or None (zeros).  Per head:
    ``o_t = r_t S_{t-1} + (r_t . u . k_t) v_t`` and
    ``S_t = diag(w_t) S_{t-1} + k_t^T v_t``, with w clipped to [1e-8, 1] as
    the model's chunked form and the Pallas kernel clip it (JAX's oracle
    does not clip).  This is the arithmetic of ``rwkv6_scan.cu``.  Returns
    ``(o (B, T, H, Dv) in r's dtype, final state (B, H, Dk, Dv) float32)``.
    """
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    S = (torch.zeros(B, H, Dk, Dv, dtype=f32, device=r.device)
         if state is None else state.to(f32))
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    wf = w.to(f32).clamp(1e-8, 1.0)
    uf = None if u is None else u.to(f32)
    outs = []
    for t in range(T):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]           # (B, H, D*)
        o = torch.einsum("bhd,bhde->bhe", rt, S)
        if uf is not None:
            o = o + (rt * uf * kt).sum(-1)[..., None] * vt
        S = wf[:, t][..., None] * S + kt[..., None] * vt[..., None, :]
        outs.append(o)
    o = (torch.stack(outs, 1) if outs
         else torch.zeros(B, 0, H, Dv, dtype=f32, device=r.device))
    return o.to(r.dtype), S


def clip_grad(w: torch.Tensor) -> torch.Tensor:
    """d clip(w, 1e-8, 1) / dw in float32, as JAX's ``jnp.clip`` gives it:
    1 inside (1e-8, 1), 0 outside [1e-8, 1], and 1/2 at w = 1e-8 or w = 1
    exactly (torch's ``clamp`` gives 1 on the bounds)."""
    wf = w.to(torch.float32)
    inside = ((wf > 1e-8) & (wf < 1.0)).to(torch.float32)
    bound = ((wf == 1e-8) | (wf == 1.0)).to(torch.float32)
    return inside + 0.5 * bound


def ref_rwkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: Optional[torch.Tensor],
                  state: Optional[torch.Tensor], do: torch.Tensor,
                  dstate_out: Optional[torch.Tensor]):
    """The backward pass of :func:`ref_rwkv6` by the reverse recurrence in
    float32, the arithmetic of ``rwkv6_scan_bwd.cu``.  With ``c(w) =
    clip(w, 1e-8, 1)`` and G_t the adjoint of S_t (G_T = ``dstate_out``,
    zeros when None; ``G_{t-1} = c(w_t) G_t + r_t^T do_t``):
    ``dr_t = S_{t-1} do_t + u k_t (v_t . do_t)``, ``dk_t = G_t v_t + r_t u
    (v_t . do_t)``, ``dv_t = G_t^T k_t + (r_t . u . k_t) do_t``, ``dw_t =
    rowsum(S_{t-1} * G_t) c'(w_t)`` (:func:`clip_grad`: JAX's 1/2 on the
    bounds), ``du = sum_{b, t} r_t k_t (v_t . do_t)`` and ``dstate =
    G_0``.  The states S_{t-1} are recomputed forward and kept (nothing is
    divided by w).  Returns ``(dr, dk, dv, dw, du, dstate)`` in the dtypes
    of r, k, v, w, u (None without u) and float32."""
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf, gf = r.to(f32), k.to(f32), v.to(f32), do.to(f32)
    wc = w.to(f32).clamp(1e-8, 1.0)
    S = (torch.zeros(B, H, Dk, Dv, dtype=f32, device=r.device)
         if state is None else state.to(f32))
    prev = []                                        # S_{t-1}
    for t in range(T):
        prev.append(S)
        S = (wc[:, t][..., None] * S
             + kf[:, t][..., None] * vf[:, t][..., None, :])
    G = (torch.zeros(B, H, Dk, Dv, dtype=f32, device=r.device)
         if dstate_out is None else dstate_out.to(f32))
    vdo = (vf * gf).sum(-1)                          # (B, T, H)
    uf = None if u is None else u.to(f32)
    dr, dk, dv, dw = ([None] * T for _ in range(4))
    for t in reversed(range(T)):
        Sp = prev[t]
        dr[t] = torch.einsum("bhij,bhj->bhi", Sp, gf[:, t])
        dk[t] = torch.einsum("bhij,bhj->bhi", G, vf[:, t])
        dv[t] = torch.einsum("bhij,bhi->bhj", G, kf[:, t])
        dw[t] = (Sp * G).sum(-1)
        if uf is not None:
            dr[t] = dr[t] + uf * kf[:, t] * vdo[:, t, :, None]
            dk[t] = dk[t] + rf[:, t] * uf * vdo[:, t, :, None]
            dv[t] = dv[t] + (rf[:, t] * uf * kf[:, t]).sum(-1)[..., None] \
                * gf[:, t]
        G = (wc[:, t][..., None] * G
             + rf[:, t][..., None] * gf[:, t][..., None, :])

    def stack(xs, D):
        return (torch.stack(xs, 1) if xs else
                torch.zeros(B, 0, H, D, dtype=f32, device=r.device))

    dwt = stack(dw, Dk) * clip_grad(w)
    du = None if u is None else \
        (rf * kf * vdo[..., None]).sum((0, 1)).to(u.dtype)
    return (stack(dr, Dk).to(r.dtype), stack(dk, Dk).to(k.dtype),
            stack(dv, Dv).to(v.dtype), dwt.to(w.dtype), du, G)


def chunked_linear_attention_ref(r: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, w: torch.Tensor,
                                 u: Optional[torch.Tensor] = None,
                                 state: Optional[torch.Tensor] = None,
                                 chunk: int = 64):
    """The wkv recurrence in the chunk-parallel form of the JAX model
    (port of ``repro.models.layers.chunked_linear_attention``), so that the
    port's model on the CPU computes what JAX's does.

    Shapes and result as :func:`ref_rwkv6`.  Inside a chunk the decays
    multiply in log space: ``r~ = r W_excl``, ``k~ = k / max(W_incl,
    1e-30)``; the output is ``r~ S + tril_strict(r~ k~^T) v`` (+ the u
    bonus) and the state ``diag(W_last) S + (k~ W_last)^T v``.  Where the
    1e-30 clamp engages (a chunk whose decays multiply below it) this form
    departs from the recurrence, which is exact."""
    B, T, H, D = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    chunk = max(1, min(chunk, T))
    n = (T + chunk - 1) // chunk
    pad = n * chunk - T
    if pad:
        r, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    S = (torch.zeros(B, H, D, Dv, dtype=f32, device=r.device)
         if state is None else state.to(f32))
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        rq, kk, vf = r[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        logw = torch.log(w[:, sl].to(f32).clamp(1e-8, 1.0))
        cum = torch.cumsum(logw, dim=1)            # prod_{s<=t} w_s
        r_t = rq * torch.exp(cum - logw)           # r W_excl
        k_t = kk / torch.clamp(torch.exp(cum), min=1e-30)
        o = torch.einsum("bchd,bhde->bche", r_t, S)
        A = torch.einsum("bchd,bshd->bhcs", r_t, k_t)
        A = torch.where(tril, A, 0.0)
        o = o + torch.einsum("bhcs,bshe->bche", A, vf)
        if u is not None:
            diag = torch.einsum("bchd,bchd->bch", rq * u.to(f32), kk)
            o = o + diag[..., None] * vf
        W_last = torch.exp(cum[:, -1])             # (B, H, D)
        S = W_last[..., None] * S + torch.einsum(
            "bchd,bche->bhde", k_t * W_last[:, None], vf)
        outs.append(o)
    o = torch.cat(outs, 1)[:, :T] if outs else \
        torch.zeros(B, 0, H, Dv, dtype=f32, device=r.device)
    return o.to(r.dtype), S
