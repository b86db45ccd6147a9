"""``place_ms.epoch``: host time in the port's ``apda.place`` spans per
traced epoch: the host array to the card (pinned past 1 MiB, then the
copy queued) and the rates (program spans)."""

from portbench.harness import spans


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    placed = spans.named(t, "apda.place")
    if not placed:
        return None
    return spans.total_ms(placed) / len(t.requests)
