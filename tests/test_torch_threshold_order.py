"""The select+scan detector's noise threshold, summed in one order on both sides.

The kernel (``csrc/detector_common.cuh`` for rows in one block's shared
memory, ``csrc/prominence_select_scan.cu``'s cluster kernel past them) and
its plain twin (``ops/stats.py`` ``ordered_mean_std``, under
``prominence_select``) take every sum of the threshold in one order, a
function of the row length H alone.  A numpy model of that order, written
here as explicit float32 loops over lanes, the warp butterfly, the warps and
the cluster's segments and independent of the port's code, is held bit-equal
to the twin; the segment constants are read from the CUDA sources.  Long
rows' std is held within 1e-6 of float64, and ``prominence_select``'s
candidate count against the model's threshold.  The kernel against the twin
is a card test (``tests/test_torch_gpu_card.py``) and ``chip_smoke.py``
phases 3, 5 and 26.
"""

import os
import re

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.ops import stats
from apda_fft_tpu_torch.ops.peaks_prominence import prominence_select
from apda_fft_tpu_torch.utils import kernels

F = np.float32
HS = [3, 32, 100, 127, 128, 129, 2048, 4097, 57856, 57857, 65536, 131072]


def _source_constant(source: str, name: str) -> int:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        text = f.read()
    expr = re.search(rf"constexpr \w+ {name} = ([0-9A-Za-z_ */()+\-]+);", text).group(1)
    return int(eval(expr, {"size_t": int, "sizeof": lambda _: 4, "float": None}))


LANES = 128
CLUSTER = _source_constant("cluster_common.cuh", "kClusterSize")
SHARED_MAX_H = 57856


def _lanes_then_tree(terms: np.ndarray, compensated: bool) -> np.float32:
    """One block's sum of ``terms`` (a whole number of 128-lane strides):
    lane l adds terms[l], terms[l+128], ... (Kahan when compensated), then
    each warp's xor butterfly at 16, 8, 4, 2, 1, then warps 0..3 in order."""
    lane = np.zeros(LANES, F)
    comp = np.zeros(LANES, F)
    for k in range(len(terms) // LANES):
        v = terms[k * LANES:(k + 1) * LANES]  # lane l's k-th term, all lanes at once
        if compensated:
            y = (v - comp).astype(F)
            t = (lane + y).astype(F)
            comp = ((t - lane).astype(F) - y).astype(F)
            lane = t
        else:
            lane = (lane + v).astype(F)
    for o in (16, 8, 4, 2, 1):
        lane = np.array([F(lane[l] + lane[l ^ o]) for l in range(LANES)], F)
    total = lane[0]
    for w in range(1, LANES // 32):
        total = F(total + lane[32 * w])
    return total


def _model_sum(terms: np.ndarray) -> np.float32:
    h = len(terms)
    if h <= SHARED_MAX_H:
        padded = np.zeros(-(-h // LANES) * LANES, F)
        padded[:h] = terms
        return _lanes_then_tree(padded, compensated=False)
    seg = -(-h // (CLUSTER * LANES)) * LANES
    total = None
    for r in range(CLUSTER):
        part = np.zeros(seg, F)
        piece = terms[r * seg:(r + 1) * seg]
        part[:len(piece)] = piece
        p = _lanes_then_tree(part, compensated=True)
        total = p if total is None else F(total + p)
    return total


def model_threshold(row: np.ndarray) -> tuple[np.float32, np.float32, np.float32]:
    """(mean, std, threshold) of one float32 row in the kernel's order."""
    h = len(row)
    mean = F(_model_sum(row) / F(h))
    d = (row - mean).astype(F)
    var = F(_model_sum((d * d).astype(F)) / F(h - 1))
    std = F(np.sqrt(var))
    return mean, std, F(mean + F(F(2.0) * std))


def _rows(h: int) -> np.ndarray:
    """A tall two-tone row over noise, a flat row and an exact row (odd bins
    at 6 or 7, like ``chip_smoke.py``'s overflow rows: every sum exact)."""
    rng = np.random.default_rng(h)
    bins = np.arange(h)
    tones = 0.05 * rng.random(h) + 1e-3
    for c, a in ((0.21 * h, 4e3), (0.63 * h, 2.5e3)):
        tones += a * np.exp(-0.5 * ((bins - c) / 1.5) ** 2)
    flat = np.full(h, 2.5)
    exact = np.zeros(h)
    odd = bins[1:min(h, 10000):2]
    exact[odd] = rng.permutation(np.resize([6.0, 7.0], len(odd)))
    return np.stack([tones, flat, exact]).astype(F)


def test_source_constants_match_the_twin():
    assert CLUSTER == stats.THRESHOLD_CLUSTER
    assert _source_constant("prominence_select_scan.cu", "kMaxThreads") == stats.THRESHOLD_LANES
    assert stats.THRESHOLD_SHARED_MAX_H == SHARED_MAX_H
    for h in (57857, 65536, 131072, 1 << 20):
        seg = stats.threshold_segment(h)
        assert seg % LANES == 0 and (CLUSTER - 1) * seg < h <= CLUSTER * seg


@pytest.mark.parametrize("h", HS)
def test_ordered_threshold_equals_the_numpy_model(h):
    rows = _rows(h)
    mean, std = stats.ordered_mean_std(torch.from_numpy(rows))
    thr, std2 = stats.ordered_noise_threshold(torch.from_numpy(rows))
    assert torch.equal(std, std2)
    for i, row in enumerate(rows):
        want = model_threshold(row)
        got = (mean[i].item(), std[i].item(), thr[i].item())
        assert [F(g).tobytes() for g in got] == [w.tobytes() for w in want], (h, i, got, want)


@pytest.mark.parametrize("h", [57857, 65536, 131072])
def test_long_rows_std_within_1e_6_of_float64(h):
    rows = _rows(h)
    _, std = stats.ordered_mean_std(torch.from_numpy(rows))
    want = rows.astype(np.float64).std(axis=-1, ddof=1)
    np.testing.assert_allclose(std.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("h", [100, 2048, 65536])
def test_candidate_count_follows_the_model_threshold(h):
    rows = _rows(h)
    # Shift the two-tone row so that one strict local maximum sits just
    # above the model's threshold and one just below it.
    _, _, thr = model_threshold(rows[0])
    row = rows[0].copy()
    for i, v in ((h // 2 + 1, np.nextafter(thr, F(np.inf))), (h // 2 + 5, thr)):
        row[i] = v
        row[i - 1] = row[i + 1] = F(0)
    rows[0] = row
    n_cand = prominence_select(torch.from_numpy(rows), 4)[-1].numpy()
    for r, x in enumerate(rows):
        _, _, t = model_threshold(x)
        interior = x[1:-1]
        want = int(((interior > x[:-2]) & (interior > x[2:]) & (interior > t)).sum())
        assert n_cand[r] == want, (h, r, n_cand[r], want)
