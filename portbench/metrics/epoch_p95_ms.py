"""``epoch_p95_ms``: the 95th percentile (linear interpolation) of every
epoch's wall time in the window, from handing the host array to
``analyze_epoch`` until every result field is on the host (host clock)."""

import numpy as np


def read(run):
    if not len(run.latencies_s):
        return None
    return float(np.percentile(run.latencies_s * 1e3, 95))
