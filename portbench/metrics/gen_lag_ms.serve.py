"""95th percentile of how late the generator handed a request to the
engine after its due time (the engine's step it waited behind)."""
import numpy as np


def read(ctx):
    s = ctx.get("lag_s")
    return 1e3 * float(np.percentile(s, 95)) if s else None
