"""``routed_share.window``: the share of requests in the traced slice that
one single-window kernel served with no batched-path detector launch, from
the port's own launch counters (``latency_cuda.launches`` and
``detector_cuda.launches`` before and after each request)."""


def read(run):
    if not run.counters:
        return None
    routed = sum(
        1 for c in run.counters
        if c["after"]["lowlat"] > c["before"]["lowlat"] and c["after"]["b1"] == c["before"]["b1"]
    )
    return 100.0 * routed / len(run.counters)
