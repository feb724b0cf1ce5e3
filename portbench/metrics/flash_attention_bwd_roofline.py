"""The attention backward's share of its roofline (the shared block's
hd 112), timed inside the harness's range around each call."""
from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "pb.flash_attention_bwd")
