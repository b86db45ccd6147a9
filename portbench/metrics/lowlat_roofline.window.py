"""``lowlat_roofline.window``: the single-window kernels' share of their
roofline over the traced slice: each launch's least time (the window read
once, its outputs written once, |rfft|'s operations; the larger at the
frozen peaks of ``harness/roofline.py``) over their device time."""

from portbench.harness import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy_us, launches = t.kernel_time_us("lowlat_")
    if not launches or busy_us <= 0:
        return None
    n, k = run.config["n_fft"], run.config["k"]
    bound = roofline.bound_s(roofline.lowlat_bytes(n, k), roofline.rfft_mag_flops(n))
    return 100.0 * launches * bound / (busy_us / 1e6)
