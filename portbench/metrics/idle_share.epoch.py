"""``idle_share``: the share of the traced slice's wall (first request's
start to last request's end) in which nothing ran on the card: 100 x (1 -
union of kernel, copy and memset intervals / wall), from the device trace."""


def read(run):
    t = run.trace
    if t is None or t.wall_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.wall_us)
