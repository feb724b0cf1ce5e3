"""The attention forward's share of its roofline in the admission
prefills (hd 128, the 4096 window), timed inside the harness's range
around each call."""
from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "pb.flash_attention")
