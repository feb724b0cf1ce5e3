"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from ..models.registry import register
from .base import ModelConfig


@register("smollm-135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab_size=49152, tie_embeddings=True,
        rope_theta=1e4,
    )
