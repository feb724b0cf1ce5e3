"""The SSD scan backward's share of its roofline: the least time its
calls' operations and bytes allow (``portbench.flops``) over the device
time of the kernels inside the harness's range around each call."""
from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "pb.mamba2_scan_bwd")
