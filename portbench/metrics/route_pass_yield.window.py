"""``route_pass_yield.window``: 100 x the traced requests that the route
alone served (an ``apda.route`` span and no ``apda.batched`` span) over
the single-window kernel calls (``apda.route.pass`` spans) of every
traced request.  A served request keeps its last pass; a re-run at a grown
budget, and every pass before a hand-off to the batched path, is waste
(program spans)."""

from portbench.harness import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    requests = spans.per_request(t)
    passes = sum(e[0] == "apda.route.pass" for req in requests for e in req)
    if not passes:
        return None
    return 100.0 * sum(spans.routed(req) for req in requests) / passes
