"""The plan of the warp walks (``csrc/walk_common.cuh``), in numpy.

The select+scan kernel (B1), the scans kernel (B5) and the flexible
single-window kernel (B2) scan each peak with one warp: ``warp_scan_at``
walks outward from the peak's bin, first over the rest of the chunk of 32
bins holding its start, then over 32 chunk maxima/minima per ballot, then
over the bins of the chunk that stops it (or, for a row without chunk
summaries, chunk by chunk over the bins).  The model here takes the same
steps on 32 lanes, with the scans kernel's clamp of a ``cid`` anywhere in
int32 into [-1, H] and the same float32 operations, and is held bit for bit against
the plain twin's masked reductions (``_prominence_and_width``) and the JAX
package's ``prominence_scans_pallas`` in interpret mode, on random,
tied-plateau and edge rows, for valid picks, peaks that are not ``x[cid]``
and bins outside [0, H).  The kernels run only on the card; this checks
their plan before any card time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops.detector_pallas import prominence_scans_pallas
from apda_fft_tpu_torch.ops import peaks_prominence as tprom

LANES = np.arange(32)
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def chunk_summaries(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Maxima and minima of the row's 32-bin chunks (``build_summaries``)."""
    h = x.shape[0]
    pad = np.full(-h % 32, np.nan, np.float32)
    chunks = np.concatenate([x, pad]).reshape(-1, 32)
    return np.nanmax(chunks, axis=1), np.nanmin(chunks, axis=1)


def warp_walk(x, start, direction, stop, chunk_stop, sm, steps):
    """``warp_walk``: the nearest index from ``start`` on one side where
    ``stop`` holds (-1 for none) and the minimum of the bins strictly
    before it.  ``steps`` counts the ballots of each stage."""
    h = x.shape[0]
    if (start < 0) if direction < 0 else (start >= h):
        return -1, np.inf

    def in_chunk(c, first_bin):
        i = first_bin + direction * LANES
        inside = ((i >> 5) == c) & (i >= 0) & (i < h)
        v = np.where(inside, x[np.clip(i, 0, h - 1)], np.float32(0))
        hit = inside & stop(v)
        first = int(np.argmax(hit)) if hit.any() else 32
        before = v[inside & (LANES < first)]
        return (first_bin + direction * first if hit.any() else -1,
                float(before.min()) if before.size else np.inf)

    mn = np.inf
    c0 = start >> 5
    found, m = in_chunk(c0, start)
    steps["start chunk"] += 1
    mn = min(mn, m)
    if found >= 0:
        return found, mn
    nc = (h + 31) // 32
    edge = lambda c: c * 32 + 31 if direction < 0 else c * 32  # noqa: E731
    if sm is None:
        c = c0 + direction
        while 0 <= c < nc:
            found, m = in_chunk(c, edge(c))
            steps["bin by bin"] += 1
            mn = min(mn, m)
            if found >= 0:
                return found, mn
            c += direction
        return -1, mn
    cmax, cmin = sm
    cb = c0 + direction
    while (cb >= 0) if direction < 0 else (cb < nc):
        c = cb + direction * LANES
        inside = (c >= 0) & (c < nc)
        cc = np.clip(c, 0, nc - 1)
        hit = inside & chunk_stop(cmin[cc], cmax[cc])
        first = int(np.argmax(hit)) if hit.any() else 32
        steps["summaries"] += 1
        before = cmin[cc][inside & (LANES < first)]
        if before.size:
            mn = min(mn, float(before.min()))
        if hit.any():
            cs = cb + direction * first
            found, m = in_chunk(cs, edge(cs))
            steps["stopping chunk"] += 1
            return found, min(mn, m)
        cb += 32 * direction
    return -1, mn


def warp_scan_at(x, j, peak, sm, steps):
    """``warp_scan_at``: (prominence, width in bins) of the peak (j, peak)."""
    h = x.shape[0]
    peak = np.float32(peak)
    j = min(max(j, -1), h)  # the scans kernel's clamp; B1's and B2's picks lie in [0, h)
    blocker = lambda v: v > peak  # noqa: E731
    chunk_blocker = lambda cmin, cmax: cmax > peak  # noqa: E731
    _, mn_l = warp_walk(x, j - 1, -1, blocker, chunk_blocker, sm, steps)
    _, mn_r = warp_walk(x, j + 1, 1, blocker, chunk_blocker, sm, steps)
    min_left = np.float32(mn_l) if mn_l < peak else peak
    min_right = np.float32(mn_r) if mn_r < peak else peak
    prom = np.float32(peak - max(min_left, min_right))
    valley = np.float32(peak - prom)
    target = np.float32(valley + np.float32(prom * np.float32(0.707)))
    outside = lambda v: (v <= target) | (v > peak)  # noqa: E731
    chunk_outside = lambda cmin, cmax: (cmin <= target) | (cmax > peak)  # noqa: E731
    st_a, _ = warp_walk(x, j, -1, outside, chunk_outside, sm, steps)
    st_b, _ = warp_walk(x, j, 1, outside, chunk_outside, sm, steps)
    return prom, max((h - 1 if st_b < 0 else st_b) - max(st_a, 0), 1)


def model_scans(mags, cid, cmag, summaries=True, steps=None):
    steps = {} if steps is None else steps
    for key in ("start chunk", "summaries", "stopping chunk", "bin by bin"):
        steps.setdefault(key, 0)
    prom = np.zeros(cid.shape, np.float32)
    bins = np.ones(cid.shape, np.int32)
    for r, x in enumerate(mags):
        sm = chunk_summaries(x) if summaries else None
        for s in range(cid.shape[1]):
            prom[r, s], bins[r, s] = warp_scan_at(x, int(cid[r, s]), cmag[r, s], sm, steps)
    return prom, bins


def _rows(h: int, kind: str, seed: int) -> np.ndarray:
    """Random, tied-plateau (runs of equal values) or edge rows (ramps, a
    V, spikes on the first and last bins, a constant)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.random((3, h)) * 5.0).astype(np.float32)
    if kind == "plateau":
        rows = []
        for _ in range(3):
            levels = np.round(rng.random(h) * 4.0) / 2.0
            runs = rng.integers(1, 40, h)
            rows.append(np.repeat(levels, runs)[:h])
        return np.stack(rows).astype(np.float32)
    i = np.arange(h, dtype=np.float32)
    spikes = np.full(h, 1.0, np.float32)
    spikes[[0, h - 1]] = 9.0
    spikes[h // 2] = 4.0
    return np.stack([i, i[::-1], np.abs(i - h / 3), spikes, np.full(h, 2.5)]).astype(np.float32)


def _slots(mags: np.ndarray, m: int):
    """Picks of the port's selection, peaks that are not x[cid], and bins
    at and past both ends of the row."""
    cid, _, cmag, _, _, _ = tprom.prominence_select(torch.from_numpy(mags), m)
    cid, cmag = cid.numpy(), cmag.numpy()
    b, h = mags.shape
    edge = np.array([0, 1, h - 2, h - 1, -1, h, h + 7, INT32_MIN, INT32_MAX], np.int64)
    edge_peak = mags[:, np.clip(edge, 0, h - 1)].copy()
    edge_peak[:, 4:] = mags.max(axis=1, keepdims=True) * np.float32(0.5)
    edge_peak[:, 6] = mags.max(axis=1) * np.float32(2.0)
    all_cid = np.concatenate([cid, cid, cid, np.broadcast_to(edge, (b, edge.size))], axis=1)
    all_peak = np.concatenate([cmag, cmag * np.float32(0.5), cmag * np.float32(2.0), edge_peak],
                              axis=1)
    return all_cid.astype(np.int32), all_peak.astype(np.float32)


def _plain(mags, cid, cmag):
    prom, bins = tprom._prominence_and_width(torch.from_numpy(mags), torch.from_numpy(cid),
                                             torch.from_numpy(cmag))
    return prom.numpy(), bins.numpy()


@pytest.mark.parametrize("kind", ["random", "plateau", "edge"])
@pytest.mark.parametrize("h", [32, 64, 200, 2048, 32768])
def test_walk_model_equals_the_masked_reductions(h, kind):
    mags = _rows(h, kind, seed=h + len(kind))
    cid, cmag = _slots(mags, 6)
    steps = {}
    got = model_scans(mags, cid, cmag, steps=steps)
    want = _plain(mags, cid, cmag)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert steps["start chunk"] > 0
    if h >= 2048 and kind != "random":  # walks cross summaries and stop in a chunk
        assert steps["summaries"] > 0 and steps["stopping chunk"] > 0


@pytest.mark.parametrize("h", [64, 2048, 32768])
def test_walk_without_summaries_equals_the_masked_reductions(h):
    """The route of rows too long for chunk summaries: chunk by chunk."""
    mags = _rows(h, "random", seed=7)[:2]
    cid, cmag = _slots(mags, 3)
    steps = {}
    got = model_scans(mags, cid, cmag, summaries=False, steps=steps)
    want = _plain(mags, cid, cmag)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert steps["bin by bin"] > 0 and steps["summaries"] == 0


@pytest.mark.parametrize("h", [32, 64, 2048, 32768])
def test_walk_model_equals_pallas_interpret(h):
    mags = np.concatenate([_rows(h, "random", seed=h)[:1], _rows(h, "plateau", seed=h)[:1],
                           _rows(h, "edge", seed=h)[:2]])
    cid, cmag = _slots(mags, 4)
    got = model_scans(mags, cid, cmag)
    n_valid = np.full(mags.shape[0], cid.shape[1], np.int32)
    want = prominence_scans_pallas(jnp.asarray(mags), jnp.asarray(cid), jnp.asarray(cmag),
                                   jnp.asarray(n_valid), block_windows=4, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
