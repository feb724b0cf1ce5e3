"""Share of the traced window in which no kernel ran (the union of the
profiler's kernel intervals against the window)."""
from portbench.metrics import idle_share


def read(ctx):
    return idle_share(ctx)
