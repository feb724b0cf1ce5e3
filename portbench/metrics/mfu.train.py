"""The whole step's share of the bf16 peak: model FLOPs of the window's
tokens (``portbench.flops``, 3x the forward) over its seconds."""
from portbench import flops


def read(ctx):
    if "model_flops_per_token" not in ctx:
        return None
    return 100.0 * ctx["tokens"] * ctx["model_flops_per_token"] / (
        ctx["window_s"] * flops.PEAK_BF16_FLOPS)
