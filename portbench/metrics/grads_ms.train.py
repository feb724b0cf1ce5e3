"""Device ms a program step inside the program's ``gradsync.grads``
range: every rank's forward and backward and the flatten."""
from portbench.metrics import range_ms


def read(ctx):
    return range_ms(ctx, "gradsync.grads")
