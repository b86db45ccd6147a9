"""``latency_p95_ms``: the 95th percentile (linear interpolation) of every
single-window request in the window, host array in and every result field
on the host (host clock)."""

import numpy as np


def read(run):
    if not len(run.latencies_s):
        return None
    return float(np.percentile(run.latencies_s * 1e3, 95))
