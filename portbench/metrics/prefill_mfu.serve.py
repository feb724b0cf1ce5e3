"""The admission steps' share of the bf16 peak: model FLOPs of the
admitted requests' true prompt tokens (no pad) over the admission
groups' host seconds."""
from portbench import flops


def read(ctx):
    a = ctx.get("admit_s")
    if not a:
        return None
    return 100.0 * ctx["prefill_flops"] / sum(a) / flops.PEAK_BF16_FLOPS
