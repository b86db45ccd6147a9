"""The port's own spans in a traced slice.

The port marks its stages with ``record_function`` ranges named
``apda.*`` (``apda_fft_tpu_torch/utils/profiling.py`` lists them), which
``trace.stop`` keeps among ``TraceSlice.host``: ``(name, start_us,
end_us)`` on the request thread.  A program without them yields no span,
and the readers of ``portbench/metrics/`` then return None.
"""

from __future__ import annotations

import bisect


def named(trace, name: str) -> list:
    """The host spans called ``name``."""
    return [e for e in trace.host if e[0] == name]


def total_ms(spans: list) -> float:
    return sum(e - s for _, s, e in spans) / 1e3


def per_request(trace) -> list[list]:
    """The ``apda.*`` spans of each request, in the order of the requests:
    a span belongs to the request whose own span holds its start."""
    starts = [r[1] for r in trace.requests]
    out: list[list] = [[] for _ in trace.requests]
    for e in trace.host:
        if not e[0].startswith("apda."):
            continue
        i = bisect.bisect_right(starts, e[1]) - 1
        if i >= 0 and e[1] < trace.requests[i][2]:
            out[i].append(e)
    return out


def routed(request: list) -> bool:
    """Whether the route alone served a request: an ``apda.route`` span and
    no ``apda.batched`` span (a hand-off has both)."""
    names = {e[0] for e in request}
    return "apda.route" in names and "apda.batched" not in names
