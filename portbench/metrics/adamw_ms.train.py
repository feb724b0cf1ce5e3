"""Device ms a program step inside ``gradsync.update``: the unflatten,
the mean and AdamW."""
from portbench.metrics import range_ms


def read(ctx):
    return range_ms(ctx, "gradsync.update")
