"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from ..models.registry import register
from .base import ModelConfig


@register("qwen2.5-3b")
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True,
        tie_embeddings=True, rope_theta=1e6,
    )
