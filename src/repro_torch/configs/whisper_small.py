"""whisper-small [audio] — enc-dec, 12L decoder (and 12L encoder)
d_model=768 12H (kv=12) d_ff=3072 vocab=51865, conv frontend stubbed to
precomputed frame embeddings (B, 1500, 768) [arXiv:2212.04356]. Decode
shapes lower the decoder with a 32k self-attn KV cache structurally (the
real model caps at 448 decoder positions — noted in DESIGN.md §7);
long_500k is skipped (full attention)."""
from ..models.registry import register
from .base import ModelConfig


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        encoder_layers=12, encoder_seq=1500, cross_attention=True,
        rope_theta=1e4,
    )
