"""``windows_per_s``: windows whose results reached the host, over the
whole measured window, from its start to the end of its last request
(host clock)."""


def read(run):
    if run.window_s <= 0 or not len(run.latencies_s):
        return None
    return float(run.windows.sum() / run.window_s)
