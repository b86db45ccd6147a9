"""``route_host_ms.window``: the mean host time of the single-window route
in a traced request that the route alone served (an ``apda.route`` span
and no ``apda.batched`` span): its ``apda.route`` span less the
``apda.route.readback`` spans inside it (program spans)."""

from portbench.harness import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [spans.total_ms([e for e in req if e[0] == "apda.route"])
             - spans.total_ms([e for e in req if e[0] == "apda.route.readback"])
             for req in spans.per_request(t) if spans.routed(req)]
    if not times:
        return None
    return sum(times) / len(times)
