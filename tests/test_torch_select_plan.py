"""The plan of the select+scan kernel ``csrc/prominence_select_scan.cu``.

The kernel runs only on the card; two facts its design rests on are checked
here against the plain selection (``peaks_prominence.prominence_select``):

* its shared candidate list holds ``H/4 + 2`` keys (up to 4096) and sends a
  longer list to its slower select-from-the-row route; by Cantelli's
  inequality no row has more than ``H/5`` bins at or above
  ``mean + 2*std``, so rows of any shape fit;
* a candidate's 64-bit key, ``(~ordered score bits) << 32 | bin``, orders
  exactly as the walk order: 4-dp-rounded magnitude descending, ties by
  ascending bin, with -0 and +0 tied.
"""

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.ops.peaks_prominence import prominence_select


def _list_cap(h: int) -> int:
    """The kernel's list length for a row of ``h`` bins when shared memory
    is not what limits it."""
    return min(h // 4 + 2, 4096) & ~1


def walk_keys(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The kernel's ``walk_key`` for bins ``idx`` of the float32 row ``x``."""
    v = x[idx].astype(np.float32)
    s = np.rint(v * np.float32(1e4)).astype(np.float32) / np.float32(1e4)
    s = np.where(s == 0, np.float32(0.0), s).astype(np.float32)
    u = s.view(np.uint32)
    ordered = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return ((~ordered).astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)


def _two_level_rows(h: int, seed: int) -> np.ndarray:
    """Rows built to carry many candidates: a fraction p of the odd bins at
    a high level (p swept), zero elsewhere."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in np.linspace(0.02, 0.5, 25):
        x = np.zeros(h, np.float32)
        odd = np.arange(1, h - 1, 2)
        hot = rng.choice(odd, size=max(1, int(p * h / 2)), replace=False)
        x[hot] = 5.0 + rng.integers(0, 4, hot.size)
        rows.append(x)
    return np.stack(rows)


@pytest.mark.parametrize("h", [32, 128, 2048, 32768])
def test_candidates_fit_the_shared_list(h):
    rng = np.random.default_rng(h)
    rows = np.concatenate([
        _two_level_rows(h, h),
        rng.random((8, h)).astype(np.float32) * 5.0,
        rng.exponential(1.0, (8, h)).astype(np.float32) ** 3,
    ])
    n_cand = prominence_select(torch.from_numpy(rows), 2)[-1].numpy()
    assert n_cand.max() <= h // 5 + 1
    if h <= 16384:
        assert n_cand.max() <= _list_cap(h)


def _spiky_row(h: int, rng) -> np.ndarray:
    """Low noise with spikes on a tenth of the odd bins at tied heights
    (3.0 + k/2), two of them at 3.0 -+ 2e-5."""
    x = rng.random(h) * 0.1
    odd = np.arange(1, h - 1, 2)
    hot = rng.choice(odd, size=max(4, h // 20), replace=False)
    x[hot] = 3.0 + rng.integers(0, 4, hot.size) / 2.0
    x[hot[:2]] = (3.0 - 2e-5, 3.0 + 2e-5)
    return x


@pytest.mark.parametrize("h", [64, 2048])
def test_walk_keys_order_is_the_walk_order(h):
    rng = np.random.default_rng(h)
    base = _spiky_row(h, rng)
    rows = np.stack([
        base,
        base * 1e-4,  # scores round to a few steps of 1e-4: ties everywhere
        base - 3.0,  # negative scores, and -0 beside +0
        base * 1e4,
    ]).astype(np.float32)
    cid, _, _, _, _, n_cand = prominence_select(torch.from_numpy(rows), h // 2)
    for r, x in enumerate(rows):
        n = int(n_cand[r])
        assert n >= 4
        keys = walk_keys(x, cid[r, :n].numpy().astype(np.int64))
        assert np.all(keys[:-1] < keys[1:]), r
