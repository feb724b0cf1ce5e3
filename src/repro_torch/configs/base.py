"""Model / run configuration dataclasses.

One ``ModelConfig`` describes any of the supported architecture families
(dense / moe / ssm / hybrid / audio enc-dec / vlm backbone); family-specific
fields are ignored by the others. Configs are plain frozen dataclasses so
they hash (used as jit static args and cache keys).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // n_heads
    qkv_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048    # 0 = ungrouped dispatch (baseline)
    # --- attention variants ---
    sliding_window: Optional[int] = None   # SWA window (Mixtral: 4096)
    # --- SSM / hybrid ---
    ssm_state: int = 0                # Mamba2 state dim N
    ssm_conv: int = 4                 # depthwise conv width
    ssm_expand: int = 2               # Mamba2 expansion factor
    ssm_headdim: int = 64             # Mamba2 SSD head dim P
    hybrid_attn_every: int = 0        # zamba2: shared attn block period
    # --- xLSTM ---
    slstm_every: int = 0              # 1-in-k layers use sLSTM (rest mLSTM)
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings length
    cross_attention: bool = False
    # --- VLM backbone ---
    vision_tokens: int = 0            # stub frontend: # patch embeddings
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family in ("ssm",) and self.hybrid_attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """Can serve very long contexts (500k) at sub-quadratic cost: SSM,
        hybrid (SSM + O(1) shared-attn KV reads) and sliding-window models
        (ring-buffer cache)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        n_layers = min(self.n_layers, 2)
        if self.hybrid_attn_every or self.slstm_every:
            n_layers = 4      # 2 groups of 2 (group scans need L % k == 0)
        base = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            n_experts=min(self.n_experts, 4),
            sliding_window=16 if self.sliding_window else None,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_seq else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        qd, kd = self.q_dim, self.kv_dim
        attn = D * qd + 2 * D * kd + qd * D
        if self.qkv_bias:
            attn += qd + 2 * kd
        mlp = 3 * D * F                      # gate/up/down (swiglu)
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + mlp + 2 * D
        elif self.family == "moe":
            n_e = (self.top_k if active_only else self.n_experts)
            per_layer = attn + n_e * mlp + D * self.n_experts + 2 * D
        elif self.family == "ssm":
            per_layer = self._ssm_block_params() + 2 * D
            if self.slstm_every:   # xLSTM mix: approximate with mLSTM size
                per_layer = self._xlstm_block_params() + 2 * D
        elif self.family == "hybrid":
            per_layer = self._ssm_block_params() + 2 * D
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + mlp + 2 * D      # one shared block
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp + 2 * D)
            total += self.n_layers * (attn + 2 * D)   # cross-attn
        total += V * D * (1 if self.tie_embeddings else 2)
        return total

    def _ssm_block_params(self) -> int:
        D = self.d_model
        d_in = self.ssm_expand * D
        nh = d_in // self.ssm_headdim
        # in_proj -> [z, x, B, C, dt] ; out_proj
        zxbcdt = 2 * d_in + 2 * self.ssm_state + nh
        return D * zxbcdt + self.ssm_conv * (d_in + 2 * self.ssm_state) \
            + 3 * nh + d_in * D

    def _xlstm_block_params(self) -> int:
        D = self.d_model
        d_in = 2 * D
        # mLSTM: up-proj to 2D, qkv, gates, out
        return D * 2 * d_in + 3 * d_in * d_in // 4 + 3 * d_in + d_in * D


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: which (arch x shape) cells run.

    ``long_500k`` needs sub-quadratic attention — skipped for pure
    full-attention archs (noted in DESIGN.md §7)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode is quadratic (skip)"
    return True, ""
