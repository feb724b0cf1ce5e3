"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304, sLSTM + mLSTM blocks
[arXiv:2405.04517]. Block mix: one sLSTM every 4 layers (xLSTM[3:1]-style),
mLSTM elsewhere; d_ff=0 (the blocks carry their own up/down projections).
Attention-free: all four shapes run, including long_500k (O(1)-state
decode)."""
from ..models.registry import register
from .base import ModelConfig


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=4, tie_embeddings=True,
    )
