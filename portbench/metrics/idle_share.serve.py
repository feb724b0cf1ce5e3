"""Share of the traced window in which no kernel ran."""
from portbench.metrics import idle_share


def read(ctx):
    return idle_share(ctx)
