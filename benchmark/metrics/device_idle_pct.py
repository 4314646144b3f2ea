"""Share of the time that the device stood idle while the requests
outside the traced stretch ran, in %: one minus the device's busy time a
request in the trace (kernels, copies and fills, overlaps counted once)
times those requests over the sum of their latencies.

The device's work is the same in and out of the trace, the host's is
not: the profiler's runtime callbacks and the spans lengthen a traced
request (by tens of percent for a single query on an H100), so the
traced window's own idle share (``busy_s`` against ``window_s``) reads
the profiler too. Each traced run logs its median request inside and
outside the traced stretch."""

import numpy as np


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or not t.requests:
        return None
    lat = np.delete(ctx.latencies, np.arange(len(ctx.latencies))[ctx.traced])
    if not len(lat):
        return None
    busy = t.busy_s() / t.requests
    return 100.0 * (1.0 - busy * len(lat) / float(lat.sum()))
