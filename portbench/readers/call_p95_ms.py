import numpy as np


def read(ctx, table):
    """95th percentile of every call of the window, call to numpy result."""
    return float(np.percentile(np.asarray(ctx.window.latencies) * 1e3, 95))
