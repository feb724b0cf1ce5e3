"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]. The anyres vision frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings (B, 576, d_model);
the text backbone runs full causal attention over [patches; tokens]."""
from ..models.registry import register
from .base import ModelConfig


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000,
        vision_tokens=576,
        rope_theta=5e6,
    )
