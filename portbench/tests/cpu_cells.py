"""The cells as the CPU tests run them: the pool cut to a size a test run
holds, and a window counted in requests, not seconds."""

from __future__ import annotations

from portbench.harness import cell as cellmod

#: Requests in a CPU test's window, after its two warm-up requests.  A
#: stale result needs two to show.
REQUESTS = 3


def small(name: str):
    """The cell ``name`` with a pool of 24 single windows or 48 rows, and
    16 rows a request where the cell batches."""
    c = cellmod.load_cell(name)
    w = c.traffic["windows_per_request"]
    c.traffic.update(pool_windows=24 if w == 1 else 48, warmup_requests=2,
                     trace_requests=REQUESTS, keep_every=1,
                     **({} if w == 1 else {"windows_per_request": 16}))
    return c
