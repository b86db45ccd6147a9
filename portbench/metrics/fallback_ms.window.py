"""``fallback_ms.window``: the mean wall of a traced request that left the
single-window route for the batched path (no ``lowlat_*`` launch, or a B1
launch besides, by the port's own launch counters), host array in and
results on the host (host clock, under the profiler)."""


def read(run):
    left = [lat for lat, c in zip(run.latencies_s, run.counters)
            if not (c["after"]["lowlat"] > c["before"]["lowlat"]
                    and c["after"]["b1"] == c["before"]["b1"])]
    if not left:
        return None
    return 1e3 * sum(left) / len(left)
