"""``launches.epoch``: kernels the card ran per epoch in the traced slice
(copies and memsets not counted), from the device trace."""


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.kernels():
        return None
    return len(t.kernels()) / len(t.requests)
