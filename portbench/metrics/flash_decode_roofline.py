"""The decode attention's share of its roofline over the ring cache,
its bytes those of the valid slots, timed inside the harness's range
around each call."""
from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "pb.flash_decode")
