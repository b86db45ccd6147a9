"""The plain float64 reference of one epoch's analysis, in NumPy.

It states the APDA-FFT reference pipeline (``metrics/fft_iterativa.py``,
``utils/get_peak_prominence.py``, ``utils/get_peak_resolution.py`` of
Copojacaab/APDA-FFT) over a ``[B, N]`` batch of windows:

* spectrum: median-centre each window, zero-pad to a power of two, FFT,
  zero the DC bin, keep the ``N/2`` magnitudes of the positive half;
* threshold: ``mean + 2 * stdev`` (sample stdev) over those magnitudes;
* flexible mode: threshold-crossing strict interior local maxima, their
  prominence (peak minus the higher flanking valley, each valley scan
  stopping at the first strictly higher sample), ``prominence > 0.5 *
  stdev``, the prominence-relative -3 dB width, damping in [0.1 %, 7 %],
  values rounded as the reference rounds them (freq and mag to 4 places,
  damping in percent and Q to 2), then the walk in rounded-magnitude order
  (ties by ascending bin) with greedy shoulder rejection up to ``k`` peaks;
* rigid mode: the destructive greedy of the resolution detector, with the
  Rayleigh-like separation test on the wiped spectrum;
* refine: the parabolic sub-bin vertex of each accepted peak, clamped to
  half a bin.

Everything is float64.  The walks of the reference (valley scans, width
scans) run as range-minimum and range-maximum queries over sparse tables,
which give the same indices the scans stop at; so the reference's CPU time
stays small at epoch sizes.  Means and deviations are NumPy's float64
reductions where the reference uses the ``statistics`` module's exact
ones: they differ in the last bits, far below every float32 reading the
comparison makes.  It imports nothing but NumPy.
"""

from __future__ import annotations

import numpy as np

MIN_DAMPING = 0.001
MAX_DAMPING = 0.07
EXCLUSION_RATIO = 0.05
MIN_PROM_RATIO = 0.10
RESOLUTION_MIN = 1.5
RESOLUTION_NORMALIZATION = 1.18
EXCLUSION_FRACTION = 0.02
HALF_POWER = 0.707

#: Rows a block: bounds the sparse tables' memory (two tables of
#: ``log2(H)`` levels of ``[rows, H]`` float64).
BLOCK_ROWS = 256

FIELDS = ("count", "idx", "freq", "mag", "prominence", "damping", "q_factor",
          "refined_freq", "n_candidates")


def half_magnitudes(x: np.ndarray) -> np.ndarray:
    """``[B, L]`` windows -> ``[B, N/2]`` float64 magnitudes, N the next
    power of two of L: median-centred, zero-padded, DC zeroed."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    n = 1
    while n < x.shape[-1]:
        n <<= 1
    centred = x - np.median(x, axis=-1, keepdims=True)
    spec = np.fft.rfft(centred, n=n, axis=-1)[:, : n // 2]
    mags = np.abs(spec)
    mags[:, 0] = 0.0
    return mags


def threshold(mags: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(mean + 2 * stdev, stdev)`` of each row, sample stdev."""
    std = np.std(mags, axis=-1, ddof=1)
    return np.mean(mags, axis=-1) + 2.0 * std, std


def candidates(mags: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """``[B, H]`` mask of strict interior local maxima above ``thr``."""
    mask = np.zeros(mags.shape, bool)
    mid = mags[:, 1:-1]
    mask[:, 1:-1] = (mid > mags[:, :-2]) & (mid > mags[:, 2:]) & (mid > thr[:, None])
    return mask


class _RangeTables:
    """Sparse tables of range minima and maxima over the rows of ``m``."""

    def __init__(self, m: np.ndarray):
        h = m.shape[1]
        self.h = h
        self.mins, self.maxs = [m], [m]
        span = 1
        while 2 * span <= h:
            lo, hi = self.mins[-1], self.maxs[-1]
            self.mins.append(np.minimum(lo[:, : h - 2 * span + 1], lo[:, span: h - span + 1]))
            self.maxs.append(np.maximum(hi[:, : h - 2 * span + 1], hi[:, span: h - span + 1]))
            span *= 2

    def query(self, rows, lo, hi):
        """(min, max) over ``[lo, hi]`` inclusive, ``lo <= hi`` elementwise."""
        length = hi - lo + 1
        lvl = np.floor(np.log2(length)).astype(np.int64)
        # Guard against log2 rounding at exact powers of two.
        lvl = np.where((1 << (lvl + 1)) <= length, lvl + 1, lvl)
        lvl = np.where((1 << lvl) > length, lvl - 1, lvl)
        right = hi - (1 << lvl) + 1
        mn = np.empty(lo.shape, np.float64)
        mx = np.empty(lo.shape, np.float64)
        for level in np.unique(lvl):
            s = lvl == level
            tmin, tmax = self.mins[level], self.maxs[level]
            r, a, b = rows[s], lo[s], right[s]
            mn[s] = np.minimum(tmin[r, a], tmin[r, b])
            mx[s] = np.maximum(tmax[r, a], tmax[r, b])
        return mn, mx

    def run_left(self, rows, j, ok):
        """Smallest ``p <= j`` with ``ok(min, max)`` over ``[p, j - 1]``
        (``p == j`` when ``j - 1`` already fails): the walk from ``j`` down."""
        p = j.copy()
        for level in range(len(self.mins) - 1, -1, -1):
            step = 1 << level
            can = p - step >= 0
            if not can.any():
                continue
            idx = np.nonzero(can)[0]
            lo = p[idx] - step
            tmin, tmax = self.mins[level], self.maxs[level]
            good = ok(tmin[rows[idx], lo], tmax[rows[idx], lo], idx)
            p[idx[good]] = lo[good]
        return p

    def run_right(self, rows, j, ok):
        """Largest ``q >= j`` with ``ok(min, max)`` over ``[j + 1, q]``."""
        q = j.copy()
        for level in range(len(self.mins) - 1, -1, -1):
            step = 1 << level
            can = q + step <= self.h - 1
            if not can.any():
                continue
            idx = np.nonzero(can)[0]
            lo = q[idx] + 1
            tmin, tmax = self.mins[level], self.maxs[level]
            good = ok(tmin[rows[idx], lo], tmax[rows[idx], lo], idx)
            q[idx[good]] = q[idx[good]] + step
        return q


def _round(values: np.ndarray, places: int) -> np.ndarray:
    """Python's ``round`` (correctly rounded, half to even on the exact
    binary value), which the reference uses."""
    return np.array([round(v, places) for v in values.tolist()], np.float64)


def _prominence_block(mags, thr, std, fs, n, k, refine):
    b, h = mags.shape
    ds = fs / n
    cand = candidates(mags, thr)
    out = _empty(b, k)
    out["n_candidates"] = cand.sum(axis=-1)
    rows, j = np.nonzero(cand)
    if rows.size == 0:
        return out
    peak = mags[rows, j]
    tables = _RangeTables(mags)

    def not_above(mn, mx, sel):
        return mx <= peak[sel]

    # Valleys: the scan from j stops at the first sample strictly above the
    # peak; the shallowest point passed (the peak itself included).
    p = tables.run_left(rows, j, not_above)
    q = tables.run_right(rows, j, not_above)
    left_valley, _ = tables.query(rows, p, j)
    right_valley, _ = tables.query(rows, j, q)
    prom = peak - np.maximum(left_valley, right_valley)
    keep = prom > 0.5 * std[rows]
    rows, j, peak, prom = rows[keep], j[keep], peak[keep], prom[keep]
    if rows.size == 0:
        return out

    # Width: the scans from j continue while target < x <= peak.
    target = (peak - prom) + prom * HALF_POWER

    def inside(mn, mx, sel):
        return (mn > target[sel]) & (mx <= peak[sel])

    p = tables.run_left(rows, j, inside)
    q = tables.run_right(rows, j, inside)
    li = np.maximum(p - 1, 0)
    ri = np.minimum(q + 1, h - 1)
    width_bins = np.maximum(ri - li, 1)
    width = width_bins * ds
    fn = j * ds
    keep = width > 0
    q_factor = np.where(keep, fn / np.where(keep, width, 1.0), 0.0)
    damping = np.where(keep, 1.0 / (2.0 * np.where(keep, q_factor, 1.0)), 0.0)
    keep &= (MIN_DAMPING <= damping) & (damping <= MAX_DAMPING)
    rows, j, peak, prom = rows[keep], j[keep], peak[keep], prom[keep]
    fn, damping, q_factor = fn[keep], damping[keep], q_factor[keep]
    if rows.size == 0:
        return out
    freq_r = _round(fn, 4)
    mag_r = _round(peak, 4)
    damp_r = _round(damping * 100.0, 2)
    q_r = _round(q_factor, 2)

    starts = np.searchsorted(rows, np.arange(b + 1))
    for r in range(b):
        lo, hi = starts[r], starts[r + 1]
        if lo == hi:
            continue
        order = lo + np.argsort(-mag_r[lo:hi], kind="stable")
        final: list[int] = []
        for c in order.tolist():
            shoulder = False
            for a in final:
                if abs(freq_r[c] - freq_r[a]) / freq_r[a] < EXCLUSION_RATIO:
                    if prom[c] / mag_r[c] < MIN_PROM_RATIO:
                        shoulder = True
                        break
            if not shoulder:
                final.append(c)
            if len(final) >= k:
                break
        s = np.asarray(final, np.int64)
        c = len(final)
        out["count"][r] = c
        out["idx"][r, :c] = j[s]
        out["freq"][r, :c] = freq_r[s]
        out["mag"][r, :c] = mag_r[s]
        out["prominence"][r, :c] = prom[s]
        out["damping"][r, :c] = damp_r[s]
        out["q_factor"][r, :c] = q_r[s]
    if refine:
        out["refined_freq"] = refine_subbin(mags, out["idx"], ds)
    return out


def _abs_width(m: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The resolution detector's absolute -3 dB width in bins, on the
    current (wiped) spectra ``m``, one bin ``j`` a row."""
    b, h = m.shape
    iota = np.arange(h)
    half = HALF_POWER * m[np.arange(b), j]
    low = m <= half[:, None]
    left = np.where(low & (iota <= j[:, None]), iota, -1).max(axis=-1)
    right = np.where(low & (iota >= j[:, None]), iota, h).min(axis=-1)
    return right - np.maximum(left, 0)


def _resolution_block(mags, thr, fs, n, k, refine):
    b, h = mags.shape
    ds = fs / n
    distance = 2 * ds - 1 * ds
    out = _empty(b, k)
    out["n_candidates"] = candidates(mags, thr).sum(axis=-1)
    m = mags.copy()
    iota = np.arange(h)
    live = np.ones(b, bool)
    rows_all = np.arange(b)
    while live.any():
        rows = rows_all[live]
        mm = m[rows]
        eligible = candidates(mm, thr[rows])
        found = eligible.any(axis=-1)
        score = np.where(eligible, mm, -np.inf)
        best = np.argmax(score, axis=-1)
        live[rows[~found]] = False
        rows, best, mm = rows[found], best[found], mm[found]
        if rows.size == 0:
            break
        best_val = mm[np.arange(rows.size), best]
        w_new = _abs_width(mm, best)
        count = out["count"][rows]
        separated = np.ones(rows.size, bool)
        for s in range(k):
            has = s < count
            if not has.any():
                continue
            pi = np.where(has, out["idx"][rows, s], 0)
            w = _abs_width(mm, pi) + w_new
            res = np.where(w == 0, 0.0,
                           RESOLUTION_NORMALIZATION * np.abs(best - pi) / np.where(w == 0, 1, w))
            separated &= ~has | (res >= RESOLUTION_MIN)
        take = rows[separated]
        slot = out["count"][take]
        out["idx"][take, slot] = best[separated]
        out["freq"][take, slot] = best[separated] * ds
        out["mag"][take, slot] = best_val[separated]
        out["count"][take] += 1
        freq = best * ds
        discard = np.array([round(v) for v in ((freq * EXCLUSION_FRACTION) / distance).tolist()],
                           np.int64)
        lo = np.maximum(best - discard, 0)
        hi = np.minimum(best + discard + 1, h)
        wipe = (iota >= lo[:, None]) & (iota < hi[:, None])
        m[rows] = np.where(wipe, 0.0, mm)
        live[rows[out["count"][rows] >= k]] = False
    if refine:
        out["refined_freq"] = refine_subbin(mags, out["idx"], ds)
    return out


def refine_subbin(mags: np.ndarray, idx: np.ndarray, ds: float) -> np.ndarray:
    """Sub-bin peak frequency: the vertex ``0.5 * (m[-1] - m[+1]) / (m[-1] -
    2 * m[0] + m[+1])`` in bins, clamped to +-0.5, times the bin width;
    0 for an empty slot."""
    h = mags.shape[-1]
    safe = np.clip(idx, 1, h - 2)
    m0 = np.take_along_axis(mags, safe - 1, axis=-1)
    m1 = np.take_along_axis(mags, safe, axis=-1)
    m2 = np.take_along_axis(mags, safe + 1, axis=-1)
    denom = m0 - 2.0 * m1 + m2
    delta = np.where(np.abs(denom) > 1e-30, 0.5 * (m0 - m2) / np.where(denom == 0, 1, denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    return np.where(idx >= 0, (safe + delta) * ds, 0.0)


def _empty(b: int, k: int) -> dict[str, np.ndarray]:
    out = {f: np.zeros((b, k), np.float64) for f in FIELDS}
    out["count"] = np.zeros(b, np.int64)
    out["n_candidates"] = np.zeros(b, np.int64)
    out["idx"] = np.full((b, k), -1, np.int64)
    return out


def analyze(windows: np.ndarray, fs: float, *, mode: str, k: int, refine: bool) -> dict:
    """The reference's results for every window of ``windows [B, L]``: a
    dict of host arrays keyed as :data:`FIELDS` (``[B]`` counts, ``[B, k]``
    slots, ``idx`` -1 and zeros past ``count``), plus ``"scale"``, each
    window's largest half-spectrum magnitude.  Prominence, damping and Q
    are zeros in rigid mode."""
    if mode not in ("flexible", "rigid"):
        raise ValueError(f"unknown mode {mode!r}")
    windows = np.asarray(windows)
    if windows.ndim == 1:
        windows = windows[None]
    n = 1
    while n < windows.shape[-1]:
        n <<= 1
    parts = []
    for lo in range(0, windows.shape[0], BLOCK_ROWS):
        mags = half_magnitudes(windows[lo: lo + BLOCK_ROWS])
        thr, std = threshold(mags)
        if mode == "flexible":
            part = _prominence_block(mags, thr, std, float(fs), n, k, refine)
        else:
            part = _resolution_block(mags, thr, float(fs), n, k, refine)
        part["scale"] = mags.max(axis=-1)
        parts.append(part)
    return {f: np.concatenate([p[f] for p in parts]) for f in (*FIELDS, "scale")}
