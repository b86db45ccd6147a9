"""The comparison that decides ``correct``.

Every kept request's host results (``loop.execute`` keeps a seeded sample
of the window's requests) are held against the plain
float64 reference (the file the configuration's ``"reference"`` names),
run once after the window over the same host windows.  The numbers, each with its limit in
``portbench/limits/<workload>.json``:

* ``windows_apart``: pool windows whose decisions differ from the
  reference in any kept request: ``count``, every ``idx`` slot,
  ``n_candidates``, and in flexible mode the rounded ``freq`` (4 places),
  ``damping`` and ``q_factor`` (2 places) of the accepted peaks, apart by
  more than ``_ROUNDED`` allows;
* ``mag_gap``: the widest gap of a peak's ``mag`` from the reference's,
  over slots where both accepted the same bin, relative to that window's
  largest reference magnitude (the front end, through the magnitudes the
  results carry; flexible mode rounds them to 4 places on both sides);
* ``prominence_gap`` (flexible): the 99th percentile of the same gaps for
  ``prominence``; not the widest, since a valley scan of either side may
  stop at, or run past, a sample within float32 rounding of the peak and
  take a valley far away (a widest gap of 1.3e-2 on one seed's pool);
* ``refined_gap`` (with refine): the widest gap of ``refined_freq`` from
  the reference's, in bins.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from portbench.harness.cell import ROOT

#: Tolerance of each rounded field: half its rounding unit; ``freq`` (bin x
#: fs / N, exact for the bin) one unit and a half, since float32 rounding
#: to 4 places lands a unit off where the product sits a hair past a half.
_ROUNDED = {"freq": 1.5e-4, "damping": 0.5e-2, "q_factor": 0.5e-2}


def _reference_module(path: str):
    """The configuration's plain reference, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_" + os.path.basename(path)[:-3], os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(cell, pool: np.ndarray, rows: np.ndarray | None = None) -> dict:
    """The reference's results over the pool's ``rows`` (every row when
    None), and each window's largest magnitude (``"scale"``), as arrays
    over the whole pool (rows left out hold zeros)."""
    cfg = cell.config
    rows = np.arange(len(pool)) if rows is None else rows
    part = _reference_module(cfg["reference"]).analyze(
        pool[rows], cfg["fs"], mode=cfg["mode"], k=cfg["k"], refine=cfg["refine"])
    out = {}
    for f, v in part.items():
        full = np.zeros((len(pool),) + v.shape[1:], v.dtype)
        full[rows] = v
        out[f] = full
    return out


def readings(cell, pool: np.ndarray, w: int, kept: list, ref: dict | None = None) -> dict:
    """The numbers of the comparison, and how many windows they cover;
    ``kept`` holds ``(first pool row, results)`` of requests of ``w`` rows."""
    cfg = cell.config
    flexible = cfg["mode"] == "flexible"
    if ref is None:
        used = np.zeros(len(pool), bool)
        for s, _ in kept:
            used[s:s + w] = True
        ref = reference(cell, pool, np.nonzero(used)[0])
    ds = cfg["fs"] / cfg["n_fft"]
    apart = np.zeros(len(pool), bool)
    compared = np.zeros_like(apart)
    gaps = {"mag_gap": 0.0}
    prom_gaps = []
    if cfg["refine"]:
        gaps["refined_gap"] = 0.0
    for s, out in kept:
        rows = slice(s, s + w)
        r = {f: v[rows] for f, v in ref.items()}
        got = {f: np.asarray(out[f]).reshape((w,) + r[f].shape[1:]) for f in
               ("count", "idx", "mag", "prominence", "damping", "q_factor", "freq",
                "refined_freq", "n_candidates")}
        same = (got["count"] == r["count"]) & (got["n_candidates"] == r["n_candidates"])
        same &= (got["idx"] == r["idx"]).all(axis=-1)
        if flexible:
            for f, tol in _ROUNDED.items():
                same &= (np.abs(got[f].astype(np.float64) - r[f]) <= tol).all(axis=-1)
        apart[rows] |= ~same
        compared[rows] = True
        both = (got["idx"] == r["idx"]) & (r["idx"] >= 0)
        scale = r["scale"][:, None]

        def widest(gap):
            gap = np.where(both, gap, 0.0)
            return float(np.max(gap)) if gap.size else 0.0

        gaps["mag_gap"] = max(gaps["mag_gap"], widest(
            np.abs(got["mag"].astype(np.float64) - r["mag"]) / scale))
        if flexible:
            prom_gaps.append((np.abs(got["prominence"].astype(np.float64) - r["prominence"])
                              / scale)[both])
        if cfg["refine"]:
            gaps["refined_gap"] = max(gaps["refined_gap"], widest(
                np.abs(got["refined_freq"].astype(np.float64) - r["refined_freq"]) / ds))
        # A NaN anywhere poisons the gap it is in (max() skips NaN).
        for f in ("mag", "prominence", "refined_freq"):
            if not np.isfinite(got[f]).all():
                gaps["mag_gap"] = float("nan")
    if flexible:
        prom = np.concatenate(prom_gaps) if prom_gaps else np.zeros(1)
        gaps["prominence_gap"] = float(np.percentile(prom, 99)) if prom.size else 0.0
        if not np.isfinite(prom).all():
            gaps["prominence_gap"] = float("nan")
    return {"windows_apart": int(apart.sum()), **gaps,
            "windows_compared": int(compared.sum())}


def compare(cell, pool: np.ndarray, w: int, kept: list) -> dict:
    """``{"numbers", "limits", "ok"}``: ``ok`` when every number the
    cell's limits name is within its limit and some window was compared."""
    numbers = readings(cell, pool, w, kept)
    limits = cell.limits
    missing = [n for n in limits if n not in numbers]
    if missing:
        raise KeyError(f"limits name numbers this cell does not read: {missing}")
    ok = numbers["windows_compared"] > 0 and all(
        bool(numbers[n] <= lim) for n, lim in limits.items())
    return {"numbers": numbers, "limits": limits, "ok": ok}
