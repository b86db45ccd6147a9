"""``setup_s``: seconds from the process's start to the first timed
request: imports, the card's context, loading (or on a first run building)
the kernels, the seeded pool and the warm-up (host clock)."""


def read(run):
    return float(run.setup_s)
