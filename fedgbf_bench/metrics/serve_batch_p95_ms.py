"""The 95th percentile of every batch call of the window, timed from the
call until its scores are in host memory."""

import numpy as np


def read(ctx):
    lat = ctx["facts"].get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
