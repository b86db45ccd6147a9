"""``lowlat_device_ms.window``: device time of the single-window kernels
(``lowlat_*``) per request in the traced slice, from the device trace."""


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    busy_us, launches = t.kernel_time_us("lowlat_")
    if not launches:
        return None
    return busy_us / 1e3 / len(t.requests)
