"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + one *shared* attention+MLP
block applied every 3 Mamba blocks (81 = 27 applications; the real model
interleaves two shared blocks ~every 6 — period chosen to divide n_layers,
noted in DESIGN.md §7) [arXiv:2411.15242]. Sub-quadratic: long_500k runs
(SSM state decode + O(1) shared-attn KV reads bounded by the cache
window)."""
from ..models.registry import register
from .base import ModelConfig


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_headdim=64,
        hybrid_attn_every=3,
        sliding_window=4096,   # shared-attn blocks use a windowed cache so
        # 500k decode stays sub-quadratic per application
    )
