"""``fallback_launches.window``: kernels the card ran for a traced request
that left the single-window route for the batched path (no ``lowlat_*``
launch, or a B1 launch besides, by the port's own launch counters), per
such request: the kernels that started inside its span, copies and
memsets not counted (device trace)."""

import bisect


def read(run):
    t = run.trace
    if t is None or len(t.requests) != len(run.counters):
        return None
    left = [r for r, c in zip(t.requests, run.counters)
            if not (c["after"]["lowlat"] > c["before"]["lowlat"]
                    and c["after"]["b1"] == c["before"]["b1"])]
    if not left:
        return None
    starts = sorted(e[1] for e in t.kernels())
    if not starts:
        return None
    count = sum(bisect.bisect_right(starts, end) - bisect.bisect_left(starts, start)
                for _, start, end in left)
    return count / len(left)
