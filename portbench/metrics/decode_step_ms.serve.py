"""Median host ms of the window's engine steps that admitted nothing: a
decode step over every slot, ended by the host's read of its tokens."""
import statistics


def read(ctx):
    s = ctx.get("decode_only_s")
    return 1e3 * statistics.median(s) if s else None
