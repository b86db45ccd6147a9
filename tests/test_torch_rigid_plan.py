"""The plan of the rigid single-window kernel (B3) in ``csrc/lowlat_window.cu``, in numpy.

The kernel runs only on the card; its plan for the destructive Rayleigh
greedy is modelled here, step for step, and held against the port's plain
twin (``_analyze_window_lowlat_plain``, rigid, i.e. ``resolution_peaks``)
and the JAX package's ``analyze_window_lowlat(mode="rigid")`` in interpret
mode:

* the candidates are ranked once by raw magnitude (descending, ties by
  ascending bin); a round's list head is the first entry still a candidate;
* a wipe only lowers bins to 0, so the only new candidates are the bins just
  outside a wiped range: the warp keeps them as "edge" candidates (64 slots),
  and a round takes the better of the list head and the best edge;
* the wipes zero the magnitudes in place and the minimum summary of every
  chunk they touch, so the -3 dB width is the warp walk of
  ``test_torch_walk_plan`` over the summaries with the stop ``v <= half``;
* a list longer than its room (``layout()``'s ``list_cap``) or an edge set
  that outgrows its slots selects each round's peak from the row.

``count``, ``idx`` and ``n_candidates`` must be equal on modal, noise,
impulse, flat and tie-heavy windows at N in {64, 1024, 4096, 65536} and fs
500 and 62.5, on quantized rows full of exact ties, and on rows whose
candidates overflow the list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import latency_pallas as jlat
from apda_fft_tpu_torch.ops import latency_cuda as tlat
from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes
from apda_fft_tpu_torch.ops.peaks_resolution import resolution_peaks
from apda_fft_tpu_torch.ops.stats import div_exact, noise_threshold
from tests.test_torch_lowlat_plan import layout
from tests.test_torch_walk_plan import chunk_summaries, warp_walk

F32 = np.float32
#: Edge candidates the warp keeps: two slots a lane.
EDGE_SLOTS = 64


def discard_count(freq: F32, ds: F32) -> int:
    """The kernel's ``discard_count``: round(f*0.02/df), halves snapped."""
    v = F32(F32(freq * F32(0.02)) / ds)
    doubled = F32(v + v)
    nearest = F32(np.rint(doubled))
    near_half = abs(F32(doubled - nearest)) < F32(1e-3)
    return int(np.rint(F32(nearest * F32(0.5)) if near_half else v))


def _candidates(w: np.ndarray, thr: F32) -> np.ndarray:
    c = np.zeros(w.shape, bool)
    c[1:-1] = (w[1:-1] > w[:-2]) & (w[1:-1] > w[2:]) & (w[1:-1] > thr)
    return c


def model_rigid(mags, thr, ds, k, list_cap, edge_slots=EDGE_SLOTS, stats=None):
    """The kernel's greedy on one row of float32 magnitudes; returns
    ``(count, idx, n_cand)``.  ``stats`` counts the rounds by where their
    peak came from and the walks' steps."""
    stats = {} if stats is None else stats
    for key in ("list", "edge", "row", "start chunk", "summaries", "stopping chunk",
                "bin by bin"):
        stats.setdefault(key, 0)
    h = mags.shape[0]
    w = mags.astype(F32).copy()
    cmax, cmin = chunk_summaries(w)
    cand = _candidates(w, thr)
    n_cand = int(cand.sum())

    def is_cand(i):
        return 1 <= i <= h - 2 and w[i] > w[i - 1] and w[i] > w[i + 1] and w[i] > thr

    order = np.flatnonzero(cand)
    ranked = order[np.lexsort((order, -w[order].astype(np.float64)))].tolist()
    from_row = n_cand > list_cap
    p, edges, idx = 0, [], []
    while len(idx) < k:
        if from_row:
            live = _candidates(w, thr)
            if not live.any():
                break
            j = int(np.argmax(np.where(live, w, -np.inf)))  # first bin on ties
            stats["row"] += 1
        else:
            while p < len(ranked) and not is_cand(ranked[p]):
                p += 1
            best = (-w[ranked[p]], ranked[p], "list") if p < len(ranked) else None
            for e in edges:
                if best is None or (-w[e], e) < best[:2]:
                    best = (-w[e], e, "edge")
            if best is None:
                break
            j = best[1]
            stats[best[2]] += 1
        peak = w[j]
        half = F32(F32(0.707) * peak)
        sm = (cmax, cmin)
        st_a, _ = warp_walk(w, j, -1, lambda v: v <= half,
                            lambda lo, hi: lo <= half, sm, stats)
        st_b, _ = warp_walk(w, j, 1, lambda v: v <= half,
                            lambda lo, hi: lo <= half, sm, stats)
        w_new = F32((h if st_b < 0 else st_b) - max(st_a, 0))
        separated = True
        for a in idx:
            rs = F32(F32(F32(1.18) * F32(abs(a - j))) / w_new) if w_new != 0 else F32(0)
            separated = separated and rs >= F32(1.5)
        if separated:
            idx.append(j)
        nd = min(max(discard_count(F32(F32(j) * ds), ds), 0), h)
        start, end = max(0, j - nd), min(h, j + nd + 1)
        w[start:end] = 0
        cmin[start >> 5:((end - 1) >> 5) + 1] = 0
        if len(idx) >= k or from_row:
            continue
        edges = [e for e in edges if is_cand(e)]
        for b in (start - 1, end):
            if is_cand(b) and b not in edges:
                if len(edges) < edge_slots:
                    edges.append(b)
                else:
                    from_row = True
    return len(idx), idx, n_cand


def _model_on(mags: torch.Tensor, fs: float, n_fft: int, k: int = 5, **kw):
    """The model on each row of ``mags [B, H]``, with the kernel's threshold
    and bin width."""
    thr, _ = noise_threshold(mags)
    ds = F32(div_exact(torch.tensor(fs, dtype=torch.float32), float(n_fft)).item())
    cap = layout(n_fft)["list_cap"]
    return [model_rigid(row.numpy(), F32(t), ds, k, cap, **kw)
            for row, t in zip(mags, thr.numpy())]


def _window(n: int, fs: float, kind: str, seed: int = 3) -> np.ndarray:
    """Modal (two tones on an offset, light noise), noise, impulse (8
    spikes), flat (a constant: no candidates) or tie-heavy (a train of equal
    impulses every 16 samples: a comb of equal spectral lines)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    if kind == "modal":
        x = (np.sin(2 * np.pi * 0.025 * fs * t) + 0.6 * np.sin(2 * np.pi * 0.095 * fs * t)
             + 0.05 * rng.standard_normal(n) + 3.0)
    elif kind == "noise":
        x = rng.standard_normal(n)
    elif kind == "impulse":
        x = np.zeros(n)
        x[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    elif kind == "flat":
        x = np.full(n, 2.5)
    else:
        x = np.zeros(n)
        x[::16] = 1.0
        x += 1e-3 * rng.standard_normal(n)
    return x.astype(np.float32)


def _plain_mags(x: torch.Tensor) -> torch.Tensor:
    """The plain twin's magnitudes of one window (mean-centred four-step)."""
    w = x[None] - div_exact(x.sum(), float(x.shape[-1]))
    return halfspec_magnitudes(w, backend="matmul")


@pytest.mark.parametrize("fs", [500.0, 62.5])
@pytest.mark.parametrize("kind", ["modal", "noise", "impulse", "flat", "ties"])
@pytest.mark.parametrize("n", [64, 1024, 4096, 65536])
def test_model_equals_plain_and_pallas(n, kind, fs):
    x = _window(n, fs, kind, seed=n % 97)
    xt = torch.from_numpy(x)
    count, idx, n_cand = _model_on(_plain_mags(xt), fs, n)[0]
    plain = tlat.analyze_window_lowlat(xt, fs, mode="rigid")
    assert (count, idx, n_cand) == (int(plain.count[0]), plain.idx[0, :count].tolist(),
                                    int(plain.n_candidates[0]))
    assert plain.idx[0, count:].tolist() == [-1] * (5 - count)
    want = jlat.analyze_window_lowlat(jnp.asarray(x), jnp.float32(fs), mode="rigid",
                                      interpret=True)
    assert count == int(want.count[0]) and n_cand == int(want.n_candidates[0])
    assert idx == np.asarray(want.idx)[0, :count].tolist()
    if kind == "flat":
        assert n_cand == 0 and count == 0


def _tie_rows(h: int, seed: int) -> np.ndarray:
    """Magnitudes quantized to steps of 0.5 (exact ties everywhere): noise
    under a few Gaussian bumps, some wider than the wipe around their peak,
    so that their flanks leave new local maxima."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    rows = []
    for r in range(6):
        x = rng.random(h) * (2.0 if r % 2 else 0.5)
        for c in rng.uniform(8, h / 4, 2 + r):
            x += rng.uniform(3, 12) * np.exp(-0.5 * ((bins - c) / rng.uniform(1, 40)) ** 2)
        rows.append(np.round(x * 2.0) / 2.0)
    out = np.stack(rows).astype(np.float32)
    out[:, 0] = 0.0
    return out


def _overflow_rows(h: int = 32768) -> np.ndarray:
    """Rows with 5000 strict maxima above the threshold, more than the
    list's 4096 keys: odd bins 1..9999 at tied levels 6 or 7, shuffled."""
    rng = np.random.default_rng(h)
    x = np.zeros((2, h), np.float32)
    levels = np.array([6.0] * 2232 + [7.0] * 2768, np.float32)
    for row in x:
        row[1:10000:2] = rng.permutation(levels)
    return x


@pytest.mark.parametrize("edge_slots", [EDGE_SLOTS, 2, 0])
@pytest.mark.parametrize("rows", ["ties-512", "ties-4096", "ties-32768", "overflow"])
def test_model_equals_resolution_peaks_on_rows(rows, edge_slots):
    """Rows of magnitudes: the greedy with ties everywhere, with a list that
    overflows, and with the edge set cut to 2 and 0 slots, so that rounds
    select from the row once it is full."""
    mags = _overflow_rows() if rows == "overflow" else _tie_rows(int(rows.split("-")[1]), 11)
    h = mags.shape[1]
    n_fft, fs = 2 * h, 500.0
    stats = {}
    got = _model_on(torch.from_numpy(mags), fs, n_fft, edge_slots=edge_slots, stats=stats)
    want = resolution_peaks(torch.from_numpy(mags), fs, n_fft, k=5)
    for r, (count, idx, n_cand) in enumerate(got):
        assert count == int(want.count[r]), r
        assert idx == want.idx[r, :count].tolist(), r
        assert n_cand == int(want.n_candidates[r]), r
    if rows == "overflow":
        assert min(g[2] for g in got) > layout(n_fft)["list_cap"]
        assert stats["row"] > 0 and stats["list"] == 0
    elif edge_slots == EDGE_SLOTS:
        assert stats["list"] > 0 and stats["edge"] > 0 and stats["row"] == 0
        # Widths of the wide bumps cross chunk summaries.
        assert stats["summaries"] > 0 and stats["stopping chunk"] > 0
    elif edge_slots == 0:
        assert stats["row"] > 0  # the first edge candidate outgrew the set


def test_rounds_take_edge_candidates():
    """On modal windows some rounds pick a bin that became a local maximum
    only when its neighbour was wiped."""
    stats = {}
    for n in (1024, 4096):
        for seed in range(3):
            x = torch.from_numpy(_window(n, 500.0, "modal", seed=seed))
            got = _model_on(_plain_mags(x), 500.0, n, stats=stats)[0]
            plain = tlat.analyze_window_lowlat(x, 500.0, mode="rigid")
            assert got[0] == int(plain.count[0]) and got[1] == plain.idx[0, :got[0]].tolist()
    assert stats["edge"] > 0


@pytest.mark.parametrize("window", ["edge-set overflow", "list overflow"])
def test_chip_smoke_overflow_windows_take_the_row_route(window):
    """The two windows ``chip_smoke.py`` phase 7 runs the kernel on past its
    shared room: the model takes the row route on them (mid-run, after 33
    list picks, once 64 edge candidates wait; and from the start, with 5000
    candidates), and equals the plain twin and the Pallas kernel."""
    import chip_smoke

    if window == "edge-set overflow":
        x, k = chip_smoke.rigid_edge_window(), 100
    else:
        x, k = chip_smoke.rigid_list_window(), 5
    n = x.shape[0]
    stats = {}
    count, idx, n_cand = _model_on(_plain_mags(torch.from_numpy(x)), 500.0, n, k=k,
                                   stats=stats)[0]
    plain = tlat.analyze_window_lowlat(torch.from_numpy(x), 500.0, mode="rigid", k=k)
    assert (count, idx, n_cand) == (int(plain.count[0]), plain.idx[0, :count].tolist(),
                                    int(plain.n_candidates[0]))
    want = jlat.analyze_window_lowlat(jnp.asarray(x), jnp.float32(500.0), mode="rigid", k=k,
                                      interpret=True)
    assert count == int(want.count[0]) and n_cand == int(want.n_candidates[0])
    assert idx == np.asarray(want.idx)[0, :count].tolist()
    assert stats["row"] > 0
    if window == "edge-set overflow":
        assert stats["list"] == 33 and count > 64  # past the bins kept in shared memory
    else:
        assert stats["list"] == 0 and n_cand > layout(n)["list_cap"]
