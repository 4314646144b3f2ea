"""95th percentile latency of all requests in the window, submission to
answers on the host (host clock), in ms."""

import numpy as np


def read(ctx):
    lat = ctx.latencies
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
