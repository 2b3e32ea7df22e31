"""Model configuration of the LM tier (port of ``repro.models.config``).

A copy of the JAX package's ``ModelConfig`` -- the same fields, defaults
and order, so a config built positionally means the same in both packages
-- with ``ShapeConfig``, ``SHAPES`` and ``cell_is_runnable``.  The port runs
every family.

Families:
  dense   — GQA transformer (qwen2/2.5, command-r)
  moe     — GQA transformer with routed-expert MLP (qwen2-moe, qwen3-moe)
  rwkv    — RWKV6 "Finch": attention-free, data-dependent decay
  hybrid  — Hymba: parallel attention + SSM heads in every block
  encdec  — Whisper: conv-frontend (stubbed) encoder + causal decoder
  vlm     — qwen2-vl: dense GQA + M-RoPE, stub vision frontend
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    rope_type: str = "rope"          # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w split of head_dim/2
    rms_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert FFN hidden size
    shared_d_ff: int = 0             # shared-expert hidden size
    router_aux_loss: float = 0.001
    capacity_factor: float = 1.25
    # --- SSM / RWKV ---
    ssm_state: int = 0               # mamba state size (hymba)
    rwkv_head_size: int = 64
    # --- attention windowing (hybrid long-context mode) ---
    sliding_window: int = 0          # 0 = full attention
    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_seq_scale: int = 1       # encoder length = seq_len (stub frames)
    # --- numerics / structure ---
    dtype: str = "bfloat16"
    remat: str = "full"              # full | dots | none
    scan_layers: bool = True
    max_position: int = 1 << 20
    # --- performance knobs (see EXPERIMENTS.md §Perf) ---
    seq_shard_activations: bool = False   # Megatron-style SP constraints
    mesh_batch_axes: Tuple[str, ...] = ("data",)
    q_head_pad: int = 0                   # pad q heads for TP divisibility
    kv_cache_dtype: str = "bfloat16"      # bfloat16 | int8 (quantized cache)
    moe_group_size: int = 512             # GShard dispatch group (tokens)
    decode_steps: int = 1                 # tokens fused per serve_step

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def effective_heads(self) -> int:
        """q heads incl. TP-divisibility padding (perf knob: pad-heads)."""
        return self.num_heads + self.q_head_pad

    @property
    def padded_experts(self) -> int:
        """Experts padded to a multiple of 16 for EP divisibility
        (qwen2-moe: 60 -> 64; DESIGN.md §6)."""
        e = self.num_experts
        return e if e % 16 == 0 else (e // 16 + 1) * 16

    @property
    def q_dim(self) -> int:
        return self.effective_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "encdec"):
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            mlp = 3 * d * self.d_ff
            per_layer = attn + mlp + 2 * d
            n = emb + L * per_layer + d
            if self.family == "encdec":
                enc_attn = attn  # self-attn
                cross = attn
                n += self.encoder_layers * (enc_attn + mlp + 2 * d)
                n += L * cross  # decoder cross-attention
            return n
        if self.family == "moe":
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            e_pad = self.padded_experts
            routed = e_pad * 3 * d * self.moe_d_ff
            shared = 3 * d * self.shared_d_ff if self.shared_d_ff else 0
            router = d * e_pad
            per_layer = attn + routed + shared + router + 2 * d
            return emb + L * per_layer + d
        if self.family == "rwkv":
            # time-mix r,k,v,g,o + channel-mix receptance (6 d^2),
            # channel mix (2*d*d_ff), decay lora (2*64*d), misc vectors
            per_layer = 6 * d * d + 2 * d * self.d_ff + 128 * d + 12 * d
            return emb + L * per_layer + d
        if self.family == "hybrid":
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            ssm = 2 * d * self.q_dim + self.q_dim * (2 * self.ssm_state + 2) \
                + self.q_dim * d
            mlp = 3 * d * self.d_ff
            return emb + L * (attn + ssm + mlp + 2 * d) + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active (per-token) params — used for MODEL_FLOPS of MoE archs."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        routed_active = self.num_experts_per_tok * 3 * d * self.moe_d_ff
        shared = 3 * d * self.shared_d_ff if self.shared_d_ff else 0
        router = d * self.padded_experts
        per_layer = attn + routed_active + shared + router + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * per_layer + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# architectures with O(L^2) full attention skip long_500k (see DESIGN.md §5)
SUBQUADRATIC_FAMILIES = ("rwkv", "hybrid")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("skipped: pure full attention is O(L^2) at 524k; "
                       "only SSM/hybrid/linear-attention archs run this "
                       "shape (DESIGN.md §5)")
    return True, ""
