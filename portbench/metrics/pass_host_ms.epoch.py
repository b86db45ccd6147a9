"""``pass_host_ms.epoch``: host time in the port's ``apda.pass`` spans per
traced epoch: queueing the front end, the detector and refine for each
pass over the epoch, its readback not counted (program spans)."""

from portbench.harness import spans


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    passes = spans.named(t, "apda.pass")
    if not passes:
        return None
    return spans.total_ms(passes) / len(t.requests)
