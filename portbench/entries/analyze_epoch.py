"""``analyze_epoch``: the entry point a request goes through, its counters
and its comparison.

A request hands one host array of windows to
``apda_fft_tpu_torch.analyze_epoch`` and waits until every result field
is a host array: what a gateway's caller waits for.  The comparison holds
the results against the configuration's plain float64 reference
(``harness/compare.py``).
"""

from __future__ import annotations

import numpy as np

from portbench.harness import compare

#: Result fields read back to the host, as ``EpochResult`` names them.
FIELDS = ("count", "idx", "freq", "mag", "prominence", "damping", "q_factor",
          "refined_freq", "n_candidates", "n_required")


def make_call(config: dict, *, device=None, precision: str | None = None):
    """The timed path: one request through the port, results to the host.

    ``precision`` overrides the configuration's (the control runs the
    port's ``"fast"`` path)."""
    from apda_fft_tpu_torch import analyze_epoch

    kw = dict(
        n_fft=config["n_fft"], mode=config["mode"], k=config["k"],
        refine=config["refine"], backend=config["backend"],
        precision=precision or config["precision"], lowlat=config["lowlat"],
        max_candidates=None if config["max_candidates"] == "dynamic" else
        config["max_candidates"],
    )
    fs = config["fs"]

    def call(x: np.ndarray) -> dict:
        res = analyze_epoch(x, fs, device=device, **kw)
        return {f: getattr(res, f).cpu().numpy() for f in FIELDS}

    return call


def counters() -> dict:
    """The port's own counts of hand-kernel launches: B1, B5, B4 and the
    single-window kernels (B2, B3)."""
    from apda_fft_tpu_torch.ops import detector_cuda, fft_cuda, latency_cuda

    return {
        "b1": detector_cuda.launches,
        "b5": detector_cuda.scan_launches,
        "b4": fft_cuda.launches,
        "lowlat": sum(latency_cuda.launches.values()),
    }


def check(cell, pool: np.ndarray, width: int, kept: list) -> dict:
    """``{"numbers", "limits", "ok"}`` of the kept requests' results."""
    return compare.compare(cell, pool, width, kept)
