"""The causal LM of the LM tier (port of ``repro.models.lm``): all six
families of the reference.

  dense  : GQA attention (RoPE, optional QKV bias) + gated-SiLU MLP
           (qwen2 / qwen2.5, command-r)
  vlm    : the dense block with M-RoPE over (t, h, w) position ids; the
           caller hands in the embeddings (stub vision frontend; qwen2-vl)
  moe    : GQA attention + routed experts with GShard dispatch, the shared
           experts and the Switch aux loss (``models/moe.py``; qwen2-moe,
           qwen3-moe)
  rwkv   : RWKV6 time-mix (token shift, data-dependent decay, the wkv scan
           with its bonus ``u``) + channel-mix
  hybrid : Hymba: attention heads and SSM heads run in parallel on the same
           input, each branch normalized, mean-fused (arXiv:2411.13676)
  encdec : Whisper: an encoder of dense blocks over stub frame embeddings
           plus sinusoids, and a decoder block with cross-attention to it;
           tied embeddings

Parameters keep the JAX package's tree and its stacked layout -- every
layer leaf has a leading ``num_layers`` axis (``layers/attn/wq`` is (L, d,
q_dim); Whisper's ``encoder/*`` leaves lead with ``encoder_layers``) -- so
:func:`repro_torch.convert.params_from_jax` output loads by leaf name
(:func:`load_params`).  A Python loop over the layers takes the place of
``scan_or_unroll``.

Entry points, as in JAX:
  forward_train(params, cfg, batch) -> per-token log-probs of the targets
      and the aux loss (the MoE's summed load-balancing loss, else 0); the
      prompt-scoring pass, and under autograd the training pass (every
      family differentiates; with ``remat="full"`` each layer runs under
      ``torch.utils.checkpoint``, JAX's ``_maybe_remat``).  Per layer it
      runs the flash-attention kernel (dense, vlm, moe, hybrid; encdec:
      causal self-attention in encoder and decoder, non-causal
      cross-attention) and the scan kernel (rwkv, hybrid) over the whole
      sequence.
  init_cache(cfg, batch, max_len) / decode_step(params, cfg, tokens, cache)
      -> (logits, cache); one token.  Dense, vlm, moe and encdec attend
      their full-length cache in plain torch (``_decode_attention``, as in
      JAX: no kernel), the hybrid family its rotating window cache; the
      scan runs at T = 1 from the carried state (rwkv's wkv state, Hymba's
      SSM state); Whisper's cross-attention runs the flash kernel with one
      query over the encoder's keys.  The VLM takes ``embeds`` and
      ``position_ids`` in place of tokens.
  encode / build_cross_cache(params, cfg, frames): Whisper's encoder and
      each decoder layer's cross-attention K/V, ``cache["cross"]``.

Unlike JAX's functional cache, :func:`decode_step` updates the cache in
place (the new K/V slot, stored positions, the int8 scales, the recurrent
states) and returns the same dict; ``cache["index"]`` is a Python int.  The
JAX layers' ``attn_chunk`` and ``ssm_chunk`` are not taken: the flash
kernel tiles the keys itself, and the scan computes the exact recurrence,
where JAX's chunk form departs from it once a chunk's decay product falls
below 1e-30 (``ROADMAP.md``, queue 3).  The int8 KV cache
(``kv_cache_dtype="int8"``: per-(token, head) scales, codes ``round(x /
s)``) is read only where JAX dequantizes it, single-token decode without a
window; the windowed and cached S > 1 branches raise (JAX attends the codes
there without their scales: ``ROADMAP.md``, queue 3, reference item 11).
Two quirks of the reference are kept (queue 3, reference items 12 and
13): Whisper's encoder self-attention is causal, and the VLM's fused
multi-token decode feeds the same embeddings at every step
(``launch/steps.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..nn.core import ParamTree, Params, normal_init_sliced
# loads params_from_jax(jax.device_get(repro.models.lm.init_params(...)))
from ..nn.core import load_flat as load_params  # noqa: F401
from .config import ModelConfig
from .layers import (apply_mrope, apply_rope, chunked_linear_attention,
                     flash_attention, gated_mlp, rmsnorm, rmsnorm_init)
from .moe import moe_block_apply, moe_block_init


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ===========================================================================
# Initializers (every layer leaf stacked over a leading L axis)
# ===========================================================================

def _stacked_ones(L: int, dim: int, dt, device) -> Params:
    return {"scale": torch.ones(L, dim, dtype=dt, device=device)}


def _stacked_init(L: int, dt, generator, device):
    """``init(*shape, dtype=dt)``: an (L,) + shape leaf of std 0.02
    normals, drawn a layer at a time (:func:`normal_init_sliced`)."""
    return lambda *shape, dtype=dt: normal_init_sliced(
        (L,) + shape, generator=generator, device=device, std=0.02,
        dtype=dtype)


def _attn_init(cfg: ModelConfig, L: int, dt, init, device) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": init(d, qd), "wk": init(d, kvd), "wv": init(d, kvd),
         "wo": init(qd, d)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(L, qd, dtype=dt, device=device)
        p["bk"] = torch.zeros(L, kvd, dtype=dt, device=device)
        p["bv"] = torch.zeros(L, kvd, dtype=dt, device=device)
    return p


def hybrid_block_init(cfg: ModelConfig, *, generator: torch.Generator,
                      device) -> Params:
    """All ``num_layers`` Hymba blocks, stacked (JAX vmaps the single-layer
    init over layer keys; the names and shapes are the same)."""
    dt = _dtype(cfg)
    L, d, qd, N = cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.ssm_state
    H = cfg.num_heads
    init = _stacked_init(L, dt, generator, device)
    return {
        "ln1": _stacked_ones(L, d, dt, device),
        "attn": _attn_init(cfg, L, dt, init, device),
        # SSM branch (mamba2-style scalar-decay heads)
        "ssm_in": init(d, qd),
        "ssm_gate": init(d, qd),
        "ssm_B": init(d, H * N),
        "ssm_C": init(d, H * N),
        "ssm_dt": init(d, H),
        "ssm_dt_bias": torch.zeros(L, H, dtype=dt, device=device),
        "ssm_A_log": torch.zeros(L, H, dtype=dt, device=device),
        "ssm_D": torch.ones(L, H, dtype=dt, device=device),
        "ssm_out": init(qd, d),
        "attn_norm": _stacked_ones(L, d, dt, device),
        "ssm_norm": _stacked_ones(L, d, dt, device),
        "ln2": _stacked_ones(L, d, dt, device),
        "mlp": {"wi_gate": init(d, cfg.d_ff), "wi_up": init(d, cfg.d_ff),
                "wo": init(cfg.d_ff, d)},
    }


def dense_block_init(cfg: ModelConfig, *, generator: torch.Generator,
                     device, num_layers: Optional[int] = None) -> Params:
    """``num_layers`` (default ``cfg.num_layers``) dense blocks, stacked:
    ``ln1``, ``attn`` (``wq``, ``wk``, ``wv``, ``wo``; ``bq``, ``bk``,
    ``bv`` with ``qkv_bias``), ``ln2``, ``mlp`` (``wi_gate``, ``wi_up``,
    ``wo``), as JAX's ``dense_block_init`` vmapped over the layers (the
    VLM's blocks and Whisper's encoder blocks too).  Each weight is drawn a
    layer at a time (:func:`normal_init_sliced`): qwen2.5-32b's
    ``mlp/wi_gate`` alone is 9.06e9 elements."""
    dt = _dtype(cfg)
    L = cfg.num_layers if num_layers is None else num_layers
    d, ff = cfg.d_model, cfg.d_ff
    init = _stacked_init(L, dt, generator, device)
    return {"ln1": _stacked_ones(L, d, dt, device),
            "attn": _attn_init(cfg, L, dt, init, device),
            "ln2": _stacked_ones(L, d, dt, device),
            "mlp": {"wi_gate": init(d, ff), "wi_up": init(d, ff),
                    "wo": init(ff, d)}}


def encdec_dec_block_init(cfg: ModelConfig, *, generator: torch.Generator,
                          device) -> Params:
    """All ``num_layers`` Whisper decoder blocks, stacked: the dense
    block's leaves plus the cross-attention ``xattn`` (the attention's
    leaves) behind its norm ``ln_x``."""
    dt = _dtype(cfg)
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    init = _stacked_init(L, dt, generator, device)
    return {"ln1": _stacked_ones(L, d, dt, device),
            "attn": _attn_init(cfg, L, dt, init, device),
            "ln_x": _stacked_ones(L, d, dt, device),
            "xattn": _attn_init(cfg, L, dt, init, device),
            "ln2": _stacked_ones(L, d, dt, device),
            "mlp": {"wi_gate": init(d, ff), "wi_up": init(d, ff),
                    "wo": init(ff, d)}}


def _moe_block_init(cfg: ModelConfig, *, generator: torch.Generator,
                    device) -> Params:
    """All ``num_layers`` MoE blocks, stacked (:func:`moe_block_init`)."""
    dt = _dtype(cfg)
    L = cfg.num_layers
    init = _stacked_init(L, dt, generator, device)
    return moe_block_init(cfg, _attn_init(cfg, L, dt, init, device), init,
                          dt, device)


#: rank of RWKV6's decay LoRA (JAX's ``rwkv_block_init``)
RWKV_LORA = 64


def rwkv_block_init(cfg: ModelConfig, *, generator: torch.Generator,
                    device) -> Params:
    """All ``num_layers`` RWKV6 blocks, stacked, with JAX's names and
    initial values: the time-mix factors ``mu`` (5, d) and ``cm_mu`` (2, d)
    at 0.5, the decay base ``w0`` at -6, the norms at 1, the rest std 0.02
    normals drawn a layer at a time."""
    dt = _dtype(cfg)
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, D = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    init = _stacked_init(L, dt, generator, device)
    full = lambda value, *shape: torch.full((L,) + shape, value, dtype=dt,
                                            device=device)
    return {
        "ln1": _stacked_ones(L, d, dt, device),
        "ln2": _stacked_ones(L, d, dt, device),
        # time-mix interpolation factors per projection (r, k, v, g, w)
        "mu": full(0.5, 5, d),
        "wr": init(d, d), "wk": init(d, d), "wv": init(d, d),
        "wg": init(d, d), "wo": init(d, d),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x W_a) W_b))
        "w0": full(-6.0, d),
        "w_lora_a": init(d, RWKV_LORA),
        "w_lora_b": init(RWKV_LORA, d),
        "bonus_u": init(H, D),
        "ln_x": _stacked_ones(L, d, dt, device),
        # channel mix
        "cm_mu": full(0.5, 2, d),
        "cm_k": init(d, ff), "cm_v": init(ff, d), "cm_r": init(d, d),
    }


BLOCK_INITS = {"dense": dense_block_init, "vlm": dense_block_init,
               "moe": _moe_block_init, "rwkv": rwkv_block_init,
               "hybrid": hybrid_block_init, "encdec": encdec_dec_block_init}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> ParamTree:
    """Random parameters, std 0.02 normals drawn from ``generator`` on its
    own device (a CUDA generator for a full-width model: 1.39 B draws for
    Hymba, 32.76 B for qwen2.5-32b), in the config's dtype, on ``device``
    (default: the generator's).  Each leaf is drawn a layer (or a block of
    embedding rows) at a time into a leaf of the config's dtype
    (:func:`normal_init_sliced`), so a model that fills most of the card
    never holds a float32 copy of a whole leaf.  The values are not JAX's
    (another generator); parity runs load JAX's.  Whisper (encdec) adds
    its encoder's ``encoder_layers`` dense blocks under ``encoder`` and
    their final norm ``enc_ln_f``."""
    dt = _dtype(cfg)
    device = generator.device if device is None else device
    params: Dict[str, Any] = {
        "embed": normal_init_sliced((cfg.vocab_size, cfg.d_model),
                                    generator=generator, device=device,
                                    dtype=dt),
        "ln_f": rmsnorm_init(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init_sliced(
            (cfg.d_model, cfg.vocab_size), generator=generator,
            device=device, dtype=dt)
    if cfg.family == "encdec":
        params["encoder"] = dense_block_init(
            cfg, generator=generator, device=device,
            num_layers=cfg.encoder_layers)
        params["enc_ln_f"] = rmsnorm_init(cfg.d_model, dt, device)
    params["layers"] = BLOCK_INITS[cfg.family](cfg, generator=generator,
                                               device=device)
    return ParamTree(params)


def _layer(stacked, i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree, as a nested dict of views."""
    return {k: (stacked[k][i] if isinstance(stacked[k], torch.Tensor)
                else _layer(stacked[k], i)) for k in stacked}


# ===========================================================================
# Block application
# ===========================================================================

def _project_qkv(p, h, cfg: ModelConfig):
    # an input of another dtype than the weights (Whisper's bf16 frames in
    # a float32 model) is promoted first, as JAX's matmul promotes it
    h = h.to(torch.promote_types(h.dtype, p["wq"].dtype))
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = h.shape[:2]
    hd = cfg.resolved_head_dim
    return (q.reshape(B, S, cfg.effective_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _rope(cfg: ModelConfig, x, positions):
    if cfg.rope_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_type == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


def attention_sublayer(p, x, cfg: ModelConfig, positions, cache=None,
                       cache_index: Optional[int] = None, window: int = 0):
    """Returns (attn_out, cache).  ``positions``: (B, S), or (3, B, S) with
    M-RoPE, whose temporal component is the position the cache stores.
    Without a cache: causal (windowed) flash attention over x.  With one
    -- dict(k, v, pos), (B, C, KVH, hd) and (B, C), and with an int8
    cache ``k_scale`` / ``v_scale`` (B, C, KVH): one layer's views of the
    stacked cache -- the new K/V and positions are written in place, then:
      - with a ``window``: at slots ``(cache_index + s) % C``, the queries
        attend the rotating window cache (``_windowed_cache_attention``);
      - without one, at slots ``cache_index + s``: for S = 1 direct
        attention over the first ``cache_index + 1`` slots in plain torch
        (``_decode_attention``, JAX's einsums, the int8 scales folded in);
        for S > 1 the flash kernel, causal from ``q_offset = cache_index``
        over ``kv_len = cache_index + S`` slots.
    An int8 cache takes the first two only where JAX dequantizes it: S = 1
    without a window; the rest raises (``ROADMAP.md``, queue 3, reference
    item 11)."""
    B, S = x.shape[:2]
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_type != "none":
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=True, window=window)
        return out.reshape(B, S, cfg.q_dim) @ p["wo"], None
    quant = cache["k"].dtype == torch.int8
    if quant and (window or S > 1):
        raise NotImplementedError(
            f"the int8 KV cache is read only by single-token decode without "
            f"a window (here window {window}, {S} tokens): the reference "
            "attends the int8 codes without their scales on the windowed "
            "and cached S > 1 branches (ROADMAP.md, queue 3, reference item "
            "11)")
    C = cache["k"].shape[1]
    if S > C or (not window and cache_index + S > C):
        raise ValueError(f"{S} new tokens at index {cache_index} do not fit "
                         f"a {C}-slot cache")
    start = cache_index % C if window else cache_index
    slot = (slice(start, start + S) if start + S <= C else
            torch.tensor([(start + s) % C for s in range(S)],
                         device=x.device))
    if quant:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        cache["k"][:, slot], cache["k_scale"][:, slot] = kq, ks
        cache["v"][:, slot], cache["v_scale"][:, slot] = vq, vs
    else:
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
    pos2d = positions[0] if positions.dim() == 3 else positions
    cache["pos"][:, slot] = pos2d.expand(B, S).to(torch.int32)
    if window:
        out = _windowed_cache_attention(q, cache["k"], cache["v"],
                                        cache["pos"], positions, window)
    elif S == 1:
        out = _decode_attention(q, cache["k"], cache["v"], cache_index + 1,
                                cache.get("k_scale"), cache.get("v_scale"))
    else:
        out = flash_attention(q, cache["k"], cache["v"], causal=True,
                              q_offset=cache_index, kv_len=cache_index + S)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], cache


def _quantize(x: torch.Tensor):
    """int8 codes and per-(token, head) scales of x (B, S, KVH, hd), as
    JAX's cache write: ``s = max|x| / 127 + 1e-9`` in float32, codes
    ``round(x / s)`` (half to even in both frameworks)."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(-1) / 127.0 + 1e-9
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _decode_attention(q, ck, cv, kv_len: int, k_scale=None, v_scale=None):
    """Direct attention for S_q = 1 over the first ``kv_len`` slots of a
    cache (plain torch in float32, as JAX's einsums: no Pallas kernel
    there).  An int8 cache's per-(token, head) scales are folded into the
    keys and values."""
    B, S, H, D = q.shape
    KVH = ck.shape[2]
    G = H // KVH
    f32 = torch.float32
    qg = q.reshape(B, S, KVH, G, D).to(f32)
    kf = ck.to(f32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
    logits = torch.einsum("bqngd,bcnd->bqngc", qg, kf) / math.sqrt(D)
    valid = torch.arange(ck.shape[1], device=q.device) < kv_len
    logits = torch.where(valid, logits,
                         torch.tensor(-1e30, dtype=f32, device=q.device))
    a = torch.softmax(logits, dim=-1)
    vf = cv.to(f32)
    if v_scale is not None:
        vf = vf * v_scale[..., None]
    out = torch.einsum("bqngc,bcnd->bqngd", a, vf)
    return out.reshape(B, S, H, D).to(q.dtype)


def _windowed_cache_attention(q, ck, cv, cpos, positions, window: int):
    """Attention over a rotating window cache, masked by the stored
    positions (plain torch, as in JAX: no Pallas kernel there)."""
    B, S, H, D = q.shape
    KVH = ck.shape[2]
    G = H // KVH
    f32 = torch.float32
    qg = q.reshape(B, S, KVH, G, D).to(f32)
    logits = torch.einsum("bqngd,bcnd->bqngc", qg, ck.to(f32)) / math.sqrt(D)
    qpos = positions.reshape(B, S)
    cp = cpos[:, None, :]
    ok = (cp >= 0) & (cp <= qpos[..., None]) & (cp > qpos[..., None] - window)
    logits = torch.where(ok[:, :, None, None, :], logits,
                         torch.tensor(-1e30, dtype=f32, device=q.device))
    a = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqngc,bcnd->bqngd", a, cv.to(f32))
    return out.reshape(B, S, H, D).to(q.dtype)


def dense_block_apply(p, x, cfg: ModelConfig, positions, cache=None,
                      cache_index: Optional[int] = None, window: int = 0):
    """Pre-norm attention then the gated MLP, each added to the residual.
    ``cache``: one layer's dict(k, v, pos) (the int8 scales with them)."""
    a, new_cache = attention_sublayer(p["attn"], rmsnorm(p["ln1"], x), cfg,
                                      positions, cache, cache_index, window)
    x = x + a
    x = x + gated_mlp(p["mlp"], rmsnorm(p["ln2"], x))
    return x, new_cache


def encdec_dec_block_apply(p, x, cfg: ModelConfig, positions, enc_kv,
                           cache=None, cache_index: Optional[int] = None):
    """Whisper's decoder block: causal self-attention (``cache`` as the
    dense block's), then cross-attention to the encoder's keys and values
    ``enc_kv = dict(k, v)`` (B, Se, KVH, hd) -- the flash kernel,
    non-causal, ``xattn``'s query and output projections without biases,
    as in JAX -- then the gated MLP, each added to the residual."""
    a, new_cache = attention_sublayer(p["attn"], rmsnorm(p["ln1"], x), cfg,
                                      positions, cache, cache_index)
    x = x + a
    h = rmsnorm(p["ln_x"], x)
    B, S = h.shape[:2]
    q = (h @ p["xattn"]["wq"]).reshape(B, S, cfg.num_heads,
                                       cfg.resolved_head_dim)
    out = flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    x = x + out.reshape(B, S, cfg.q_dim) @ p["xattn"]["wo"]
    x = x + gated_mlp(p["mlp"], rmsnorm(p["ln2"], x))
    return x, new_cache


def _shifted(h: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """RWKV's token shift: h one step late, the carried ``last`` (B, d) (or
    zeros) first."""
    first = (last[:, None] if last is not None else
             torch.zeros_like(h[:, :1]))
    return torch.cat([first, h[:, :-1]], dim=1)


def rwkv_block_apply(p, x, cfg: ModelConfig, state=None):
    """RWKV6 (Finch): time-mix with data-dependent decay, then channel-mix,
    op by op as JAX's ``rwkv_block_apply``.  The mixes, the projections,
    the SiLU gate and the channel mix run in the config's dtype; the LoRA
    decay ``w = exp(-exp(clip(w0 + tanh(x W_a) W_b, -8, 4)))`` in float32
    and reaches the scan in float32 (in bf16 the initial decay
    exp(-e^-6) ~ 0.9975 would round to 0.996 or 1).  ``state``: dict(shift
    (B, d), wkv (B, H, D, D) float32, cm_shift (B, d)) or None (zeros).
    Returns (x, new state)."""
    B, S, d = x.shape
    H, D = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    f32 = torch.float32

    h = rmsnorm(p["ln1"], x)
    prev = _shifted(h, state["shift"] if state is not None else None)

    def mix(i):
        mu = p["mu"][i]
        return h * mu + prev * (1 - mu)

    xr, xk, xv, xg, xw = (mix(i) for i in range(5))
    r = (xr @ p["wr"]).reshape(B, S, H, D)
    k = (xk @ p["wk"]).reshape(B, S, H, D)
    v = (xv @ p["wv"]).reshape(B, S, H, D)
    g = F.silu(xg @ p["wg"])
    logw = -torch.exp(torch.clip(
        p["w0"].to(f32)
        + (torch.tanh(xw.to(f32) @ p["w_lora_a"].to(f32))
           @ p["w_lora_b"].to(f32)), -8.0, 4.0))
    w = torch.exp(logw).reshape(B, S, H, D)          # decay in (0, 1)
    wkv_state = state["wkv"] if state is not None else None
    o, new_wkv = chunked_linear_attention(r, k, v, w, p["bonus_u"],
                                          state=wkv_state)
    o = rmsnorm(p["ln_x"], o.reshape(B, S, d)) * g
    x = x + o @ p["wo"]

    # channel mix
    h2 = rmsnorm(p["ln2"], x)
    prev2 = _shifted(h2, state["cm_shift"] if state is not None else None)
    mk = h2 * p["cm_mu"][0] + prev2 * (1 - p["cm_mu"][0])
    mr = h2 * p["cm_mu"][1] + prev2 * (1 - p["cm_mu"][1])
    kk = torch.square(torch.relu(mk @ p["cm_k"]))
    x = x + torch.sigmoid(mr @ p["cm_r"]) * (kk @ p["cm_v"])
    return x, {"shift": h[:, -1], "wkv": new_wkv, "cm_shift": h2[:, -1]}


def hybrid_block_apply(p, x, cfg: ModelConfig, positions, cache=None,
                       cache_index: Optional[int] = None):
    """Hymba: attention heads (over ``cfg.sliding_window``) and SSM heads
    in parallel on the same input, per-branch normalization, mean fusion.
    ``cache``: dict(attn, ssm)."""
    B, S, d = x.shape
    H, N, hd = cfg.num_heads, cfg.ssm_state, cfg.resolved_head_dim
    h = rmsnorm(p["ln1"], x)
    attn_cache = cache["attn"] if cache is not None else None
    a, new_attn_cache = attention_sublayer(
        p["attn"], h, cfg, positions, attn_cache, cache_index,
        cfg.sliding_window)
    xs = h @ p["ssm_in"]                                  # (B, S, qd)
    z = F.silu(h @ p["ssm_gate"])
    Bt = (h @ p["ssm_B"]).reshape(B, S, H, N)
    Ct = (h @ p["ssm_C"]).reshape(B, S, H, N)
    dt = F.softplus(h @ p["ssm_dt"] + p["ssm_dt_bias"])   # (B, S, H)
    A = torch.exp(p["ssm_A_log"].to(torch.float32))       # (H,)
    w_scalar = torch.exp(-dt.to(torch.float32) * A)       # (B, S, H)
    w = w_scalar[..., None].expand(B, S, H, N)
    xs_h = xs.reshape(B, S, H, hd)
    vt = xs_h * dt[..., None].to(xs.dtype)
    ssm_state = cache["ssm"] if cache is not None else None
    y, new_ssm = chunked_linear_attention(Ct, Bt, vt, w, None,
                                          state=ssm_state)
    y = y + p["ssm_D"][None, None, :, None] * xs_h
    y = (y.reshape(B, S, cfg.q_dim) * z) @ p["ssm_out"]
    fused = 0.5 * (rmsnorm({"scale": p["attn_norm"]["scale"]},
                           a.to(x.dtype))
                   + rmsnorm({"scale": p["ssm_norm"]["scale"]},
                             y.to(x.dtype)))
    x = x + fused
    x = x + gated_mlp(p["mlp"], rmsnorm(p["ln2"], x))
    new_cache = None
    if cache is not None:
        new_cache = {"attn": new_attn_cache, "ssm": new_ssm}
    return x, new_cache


# ===========================================================================
# Whole-model passes
# ===========================================================================

def _cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor) -> Dict[str, Any]:
    """One decoder layer's cross-attention keys and values over the encoder
    output (B, Se, d): ``xattn``'s ``wk`` / ``wv``, no bias (as JAX)."""
    B, Se = enc_out.shape[:2]
    shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": (enc_out @ p["xattn"]["wk"]).reshape(shape),
            "v": (enc_out @ p["xattn"]["wv"]).reshape(shape)}


def _maybe_remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, one layer, as JAX's ``_maybe_remat`` wraps a layer:
    with ``remat="full"`` and autograd recording, under
    ``torch.utils.checkpoint`` (non-reentrant): the layer's activations are
    dropped after the forward and recomputed in the backward, so the flash
    and scan kernels run their forward twice and their backward once per
    layer.  ``remat="dots"`` (keep the matmul outputs) raises when
    differentiated: no config uses it.  Without autograd (scoring,
    serving) the layer runs plainly."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' is not ported: no configuration uses it")
    if cfg.remat == "full":
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def backbone(params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
             return_aux: bool = False):
    """The decoder blocks, layer by layer (training / scoring path, no
    cache), then the final norm; each layer under :func:`_maybe_remat`.
    ``enc_out``: Whisper's encoder output, whose cross-attention K/V each
    layer projects.  With ``return_aux`` returns (x, aux): the MoE's
    load-balancing losses summed over the layers in float32 (differentiable:
    the objective adds them, as JAX's ``loss_fn``), 0 for the other
    families."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        if cfg.family in ("dense", "vlm"):
            x = _maybe_remat(
                cfg, lambda x, p=p: dense_block_apply(p, x, cfg,
                                                      positions)[0], x)
        elif cfg.family == "moe":
            x, aux_l = _maybe_remat(
                cfg, lambda x, p=p: moe_block_apply(
                    p, x, cfg, positions, attention_sublayer,
                    rmsnorm)[::2], x)
            aux = aux + aux_l
        elif cfg.family == "rwkv":
            x = _maybe_remat(
                cfg, lambda x, p=p: rwkv_block_apply(p, x, cfg)[0], x)
        elif cfg.family == "hybrid":
            x = _maybe_remat(
                cfg, lambda x, p=p: hybrid_block_apply(p, x, cfg,
                                                       positions)[0], x)
        elif cfg.family == "encdec":
            x = _maybe_remat(
                cfg, lambda x, p=p: encdec_dec_block_apply(
                    p, x, cfg, positions, _cross_kv(p, cfg, enc_out))[0], x)
        else:
            raise ValueError(cfg.family)
    x = rmsnorm(params["ln_f"], x)
    return (x, aux) if return_aux else x


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) float32 sinusoids of ``positions`` (...), JAX's Whisper
    form: the sines of every angle ``pos / 10000^(2i / d)``, then the
    cosines (concatenated halves, not interleaved)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = positions.to(torch.float32)[..., None] / torch.pow(10000.0,
                                                             dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoidal_pos(S: int, d: int, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """(S, d) sinusoidal position table in ``dtype``, computed on the host
    in float32 (the same table whatever the device) and moved."""
    return _sinusoid(torch.arange(S), d).to(dtype).to(device)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, S, d): the frames
    plus the sinusoid table in their dtype, ``encoder_layers`` dense blocks
    and ``enc_ln_f``.  Its self-attention is causal: JAX's ``encode`` calls
    ``attention_sublayer`` without a cache, whose flash call is causal
    (``ROADMAP.md``, queue 3, reference item 12); the port keeps that."""
    B, S, _ = frames.shape
    x = frames + _sinusoidal_pos(S, cfg.d_model, frames.dtype, frames.device)
    positions = torch.arange(S, device=frames.device)[None].expand(B, S)
    for i in range(cfg.encoder_layers):
        p = _layer(params["encoder"], i)
        x = _maybe_remat(
            cfg, lambda x, p=p: dense_block_apply(p, x, cfg, positions)[0], x)
    return rmsnorm(params["enc_ln_f"], x)


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def chunked_target_logprobs(x: torch.Tensor, head: torch.Tensor,
                            targets: torch.Tensor,
                            chunk: int = 512) -> torch.Tensor:
    """log p(target_t) per position, (B, S) float32, without
    materializing (S, V) logits: ``chunk`` positions at a time (under
    autograd each chunk's float32 logits are kept for its backward, as
    JAX's scan keeps its residuals)."""
    S = x.shape[1]
    out = []
    for s0 in range(0, S, chunk):
        logits = (x[:, s0:s0 + chunk] @ head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           targets[:, s0:s0 + chunk, None].long())[..., 0]
        out.append(tgt - lse)
    return torch.cat(out, dim=1)


def forward_train(params, cfg: ModelConfig,
                  batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-token target log-probs (B, S) float32, aux loss) for ``batch``:
    ``targets`` (B, S) integer and
      - ``tokens`` (B, S) integer (every family but the VLM);
      - the VLM: ``embeds`` (B, S, d) and ``position_ids`` (3, B, S) in
        place of tokens;
      - Whisper: ``frames`` (B, Se, d) too, encoded first.
    The aux loss is the MoE's summed load-balancing loss, else 0."""
    enc_out = None
    if cfg.family == "vlm":
        x, positions = batch["embeds"], batch["position_ids"]
    else:
        tokens = batch["tokens"]
        # F.embedding: its backward on CUDA sums repeated tokens in a
        # fixed order (an indexed gather's would use atomics)
        x = F.embedding(tokens.long(), params["embed"])
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.family == "encdec":
            enc_out = encode(params, cfg, batch["frames"])
            x = x + _sinusoidal_pos(S, cfg.d_model, x.dtype, x.device)
    x, aux = backbone(params, cfg, x, positions, enc_out=enc_out,
                      return_aux=True)
    return chunked_target_logprobs(x, _head_matrix(params, cfg),
                                   batch["targets"]), aux


# ===========================================================================
# KV-cache decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Any]:
    """The decode cache, JAX's tree, ``index`` 0:
      - dense, vlm, moe, encdec: ``kv`` of ``max_len`` K/V slots per layer,
        (L, B, max_len, KVH, hd), stored positions (L, B, max_len) at -1
        (empty); encdec also ``cross``, None until
        :func:`build_cross_cache` fills it;
      - rwkv: the token shifts ``shift`` and ``cm_shift`` (L, B, d) in the
        config's dtype and the wkv state (L, B, H, D, D) float32;
      - hybrid: ``kv`` over a rotating window of min(sliding_window,
        max_len) slots and the SSM state (L, B, H, ssm_state, head_dim)
        float32.
    With ``kv_cache_dtype="int8"`` K/V are int8 codes beside float32
    ``k_scale`` / ``v_scale`` (L, B, slots, KVH)."""
    dt = _dtype(cfg)
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    f32 = torch.float32

    def kv(length):
        quant = cfg.kv_cache_dtype == "int8"
        c = {name: torch.zeros(L, batch, length, KVH, hd,
                               dtype=torch.int8 if quant else dt,
                               device=device) for name in ("k", "v")}
        c["pos"] = torch.full((L, batch, length), -1, dtype=torch.int32,
                              device=device)
        if quant:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(L, batch, length, KVH, dtype=f32,
                                      device=device)
        return c

    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        cache: Dict[str, Any] = {"kv": kv(max_len)}
        if cfg.family == "encdec":
            cache["cross"] = None
    elif cfg.family == "rwkv":
        H, D = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        cache = {"shift": torch.zeros(L, batch, cfg.d_model, dtype=dt,
                                      device=device),
                 "cm_shift": torch.zeros(L, batch, cfg.d_model, dtype=dt,
                                         device=device),
                 "wkv": torch.zeros(L, batch, H, D, D, dtype=f32,
                                    device=device)}
    elif cfg.family == "hybrid":
        cache = {"kv": kv(min(cfg.sliding_window or max_len, max_len)),
                 "ssm": torch.zeros(L, batch, cfg.num_heads, cfg.ssm_state,
                                    hd, dtype=f32, device=device)}
    else:
        raise ValueError(cfg.family)
    cache["index"] = 0
    return cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any], embeds: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) -> logits (B, V) float32; the cache
    is updated in place and returned.  The VLM reads ``embeds`` (B, 1, d)
    and ``position_ids`` (3, B, 1) and not ``tokens`` (the cache stores the
    temporal position); Whisper adds the sinusoid at ``cache["index"]`` to
    the token's embedding and attends ``cache["cross"]``
    (:func:`build_cross_cache`)."""
    idx = int(cache["index"])
    if cfg.family == "vlm":
        if embeds is None or position_ids is None:
            raise ValueError("decode_step: the VLM takes embeds (B, 1, d) "
                             "and position_ids (3, B, 1) in place of tokens")
        x, positions = embeds, position_ids
    else:
        x = params["embed"][tokens]
        positions = torch.full((tokens.shape[0], 1), idx, dtype=torch.int32,
                               device=tokens.device)
        if cfg.family == "encdec":
            if cache.get("cross") is None:
                raise ValueError("decode_step: Whisper's cache has no cross "
                                 "K/V; fill cache['cross'] with "
                                 "build_cross_cache first")
            at = torch.full((), float(idx), device=x.device)
            x = x + _sinusoid(at, cfg.d_model).to(x.dtype)
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        if cfg.family == "rwkv":
            state = {name: cache[name][i]
                     for name in ("shift", "cm_shift", "wkv")}
            x, new = rwkv_block_apply(p, x, cfg, state=state)
            for name, t in state.items():
                t.copy_(new[name])
            continue
        kv = {name: t[i] for name, t in cache["kv"].items()}
        if cfg.family in ("dense", "vlm"):
            x, _ = dense_block_apply(p, x, cfg, positions, cache=kv,
                                     cache_index=idx)
        elif cfg.family == "moe":
            x, _, _ = moe_block_apply(p, x, cfg, positions,
                                      attention_sublayer, rmsnorm, cache=kv,
                                      cache_index=idx)
        elif cfg.family == "encdec":
            cross = {name: cache["cross"][name][i] for name in ("k", "v")}
            x, _ = encdec_dec_block_apply(p, x, cfg, positions, cross,
                                          cache=kv, cache_index=idx)
        else:
            x, new = hybrid_block_apply(p, x, cfg, positions,
                                        cache={"attn": kv,
                                               "ssm": cache["ssm"][i]},
                                        cache_index=idx)
            cache["ssm"][i].copy_(new["ssm"])
    cache["index"] = idx + 1
    x = rmsnorm(params["ln_f"], x)
    logits = (x[:, 0] @ _head_matrix(params, cfg)).to(torch.float32)
    return logits, cache


def build_cross_cache(params, cfg: ModelConfig,
                      frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Whisper: encode ``frames`` (B, Se, d) once and project every
    decoder layer's cross-attention K/V: ``{"k", "v"}`` (L, B, Se, KVH,
    hd), for ``cache["cross"]``."""
    enc_out = encode(params, cfg, frames)
    per_layer = [_cross_kv(_layer(params["layers"], i), cfg, enc_out)
                 for i in range(cfg.num_layers)]
    return {name: torch.stack([c[name] for c in per_layer])
            for name in ("k", "v")}
