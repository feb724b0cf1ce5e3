"""The decode steps' share of the bf16 peak: model FLOPs of the served
decode tokens (live rows only) over the engine steps' host seconds
less the admissions'."""
from portbench import flops


def read(ctx):
    s = ctx.get("step_s")
    if not s:
        return None
    t = sum(s) - sum(ctx.get("admit_s", ()))
    return 100.0 * ctx["decode_flops"] / t / flops.PEAK_BF16_FLOPS
