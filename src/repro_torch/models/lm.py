"""The causal LM of the LM tier, hybrid family (port of ``repro.models.lm``).

Hymba blocks: attention heads and SSM heads run in parallel on the same
input, each branch normalized, mean-fused (arXiv:2411.13676).  Parameters
keep the JAX package's tree and its stacked layout -- every layer leaf has a
leading ``num_layers`` axis (``layers/attn/wq`` is (L, d, q_dim)) -- so
:func:`repro_torch.convert.params_from_jax` output loads by leaf name
(:func:`load_params`).  A Python loop over the layers takes the place of
``scan_or_unroll``.

Entry points, as in JAX:
  forward_train(params, cfg, batch) -> per-token log-probs of the targets
      and the aux loss (0 here); the prompt-scoring pass.  Per layer it runs
      the flash-attention kernel and the scan kernel over the whole sequence.
  init_cache(cfg, batch, max_len) / decode_step(params, cfg, tokens, cache)
      -> (logits, cache); one token, the scan at T = 1 from the carried SSM
      state and attention over the rotating window cache.

Unlike JAX's functional cache, :func:`decode_step` updates the cache in
place (the new K/V slot, stored positions and SSM state) and returns the
same dict; ``cache["index"]`` is a Python int.  The JAX layers'
``attn_chunk`` and ``ssm_chunk`` are not taken: the flash kernel tiles the
keys itself, and the SSM heads run the exact recurrence, where JAX's chunk
form departs from it once a chunk's decay product falls below 1e-30
(``ROADMAP.md``, queue 3).  Other
families, the int8 cache and cached attention without a window (the
``_decode_attention`` and S > 1 flash branches) raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.core import ParamTree, Params, normal_init
# loads params_from_jax(jax.device_get(repro.models.lm.init_params(...)))
from ..nn.core import load_flat as load_params  # noqa: F401
from .config import ModelConfig
from .layers import (apply_rope, chunked_linear_attention, flash_attention,
                     gated_mlp, gated_mlp_init, rmsnorm, rmsnorm_init)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _require_hybrid(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family is not ported to repro_torch "
            "yet (only 'hybrid'; see ROADMAP.md)")


# ===========================================================================
# Initializers (every layer leaf stacked over a leading L axis)
# ===========================================================================

def _stacked_ones(L: int, dim: int, dt, device) -> Params:
    return {"scale": torch.ones(L, dim, dtype=dt, device=device)}


def _attn_init(cfg: ModelConfig, dt, *, generator, device) -> Params:
    L, d, qd, kvd = cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim
    init = lambda *shape: normal_init((L,) + shape, generator=generator,
                                      device=device, std=0.02, dtype=dt)
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
    init = lambda *shape: normal_init((L,) + shape, generator=generator,
                                      device=device, std=0.02, dtype=dt)
    return {
        "ln1": _stacked_ones(L, d, dt, device),
        "attn": _attn_init(cfg, dt, generator=generator, device=device),
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
        "mlp": gated_mlp_init(d, cfg.d_ff, generator=generator,
                              device=device, dtype=dt, layers=L),
    }


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> ParamTree:
    """Random parameters, std 0.02 normals drawn from ``generator`` on its
    own device (a CUDA generator for a full-width model: 1.39 B draws), in
    the config's dtype, on ``device`` (default: the generator's).  The
    values are not JAX's (another generator); parity runs load JAX's."""
    _require_hybrid(cfg, "init_params")
    dt = _dtype(cfg)
    device = generator.device if device is None else device
    params: Dict[str, Any] = {
        "embed": normal_init((cfg.vocab_size, cfg.d_model),
                             generator=generator, device=device, dtype=dt),
        "ln_f": rmsnorm_init(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init((cfg.d_model, cfg.vocab_size),
                                     generator=generator, device=device,
                                     dtype=dt)
    params["layers"] = hybrid_block_init(cfg, generator=generator,
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
        raise NotImplementedError("M-RoPE comes with the VLM family "
                                  "(ROADMAP.md)")
    return x


def attention_sublayer(p, x, cfg: ModelConfig, positions, cache=None,
                       cache_index: Optional[int] = None, window: int = 0):
    """Returns (attn_out, cache).  Without a cache: causal (windowed) flash
    attention over x.  With one -- dict(k, v, pos), (B, C, KVH, hd) and
    (B, C), one layer's views of the stacked cache -- the new K/V and
    positions are written in place at slots ``(cache_index + s) % C`` and
    the queries attend the rotating window cache."""
    B, S = x.shape[:2]
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_type != "none":
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=True, window=window)
    else:
        if cache["k"].dtype == torch.int8:
            raise NotImplementedError("the int8 KV cache is not ported yet "
                                      "(ROADMAP.md)")
        if not window:
            raise NotImplementedError(
                "cached attention without a window (_decode_attention, and "
                "flash attention with q_offset for S > 1) comes with the "
                "dense family (ROADMAP.md)")
        C = cache["k"].shape[1]
        if S > C:
            raise ValueError(f"{S} new tokens do not fit a {C}-slot cache")
        start = cache_index % C
        slot = (slice(start, start + S) if start + S <= C else
                torch.tensor([(start + s) % C for s in range(S)],
                             device=x.device))
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
        cache["pos"][:, slot] = positions.expand(B, S).to(torch.int32)
        out = _windowed_cache_attention(q, cache["k"], cache["v"],
                                        cache["pos"], positions, window)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], cache


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

def backbone(params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """The decoder blocks, layer by layer (training / scoring path, no
    cache), then the final norm."""
    _require_hybrid(cfg, "backbone")
    for i in range(cfg.num_layers):
        x, _ = hybrid_block_apply(_layer(params["layers"], i), x, cfg,
                                  positions)
    return rmsnorm(params["ln_f"], x)


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def chunked_target_logprobs(x: torch.Tensor, head: torch.Tensor,
                            targets: torch.Tensor,
                            chunk: int = 512) -> torch.Tensor:
    """log p(target_t) per position, (B, S) float32, without
    materializing (S, V) logits: ``chunk`` positions at a time."""
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
    """(per-token target log-probs (B, S), aux loss) for
    ``batch = {"tokens", "targets"}``, both (B, S) integer."""
    _require_hybrid(cfg, "forward_train")
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = backbone(params, cfg, x, positions)
    lp = chunked_target_logprobs(x, _head_matrix(params, cfg),
                                 batch["targets"])
    return lp, torch.zeros((), dtype=torch.float32, device=lp.device)


# ===========================================================================
# KV-cache decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Any]:
    """The hybrid cache: a rotating window of min(sliding_window, max_len)
    K/V slots per layer (stored positions -1 = empty) and the SSM state
    (L, B, H, ssm_state, head_dim) float32; ``index`` 0."""
    _require_hybrid(cfg, "init_cache")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP.md)")
    dt = _dtype(cfg)
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    length = min(cfg.sliding_window or max_len, max_len)
    kv = {"k": torch.zeros(L, batch, length, KVH, hd, dtype=dt,
                           device=device),
          "v": torch.zeros(L, batch, length, KVH, hd, dtype=dt,
                           device=device),
          "pos": torch.full((L, batch, length), -1, dtype=torch.int32,
                            device=device)}
    ssm = torch.zeros(L, batch, cfg.num_heads, cfg.ssm_state, hd,
                      dtype=torch.float32, device=device)
    return {"kv": kv, "ssm": ssm, "index": 0}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) -> logits (B, V) float32; the cache
    is updated in place and returned."""
    _require_hybrid(cfg, "decode_step")
    idx = int(cache["index"])
    x = params["embed"][tokens]
    B = tokens.shape[0]
    positions = torch.full((B, 1), idx, dtype=torch.int32,
                           device=tokens.device)
    kvs = cache["kv"]
    for i in range(cfg.num_layers):
        lc = {"attn": {"k": kvs["k"][i], "v": kvs["v"][i],
                       "pos": kvs["pos"][i]},
              "ssm": cache["ssm"][i]}
        x, nc = hybrid_block_apply(_layer(params["layers"], i), x, cfg,
                                   positions, cache=lc, cache_index=idx)
        cache["ssm"][i].copy_(nc["ssm"])
    cache["index"] = idx + 1
    x = rmsnorm(params["ln_f"], x)
    logits = (x[:, 0] @ _head_matrix(params, cfg)).to(torch.float32)
    return logits, cache
