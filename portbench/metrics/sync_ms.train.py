"""Device ms a program step inside ``gradsync.sync``: the epoch's
schedule over the stacked buffer (``bucket_combine``)."""
from portbench.metrics import range_ms


def read(ctx):
    return range_ms(ctx, "gradsync.sync")
