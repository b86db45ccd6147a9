"""The plan of the single-window kernels ``csrc/lowlat_window.cu``.

The kernels run only on the card; two parts of their plan are checked here:

* ``layout()``, mirrored from the source's constants: for every window
  length the route takes (one layout for both modes), the shared-memory
  part fits the 227 KB a block may use, the magnitudes are always in it,
  and the FFT buffers go to the global workspace only from N = 32768 on,
  beside a candidate list that holds every candidate (``H/4 + 2`` keys, at
  most 4096);
* the flexible kernel's finalize: its picks are scanned in rounds of 64,
  then thread 0 walks them in order and stops at the k-th acceptance.  A
  model of that walk, on picks from ``prominence_select`` and scans from
  ``_prominence_and_width``, gives ``prominence_finalize``'s count, idx and
  n_required on random and overflow-shaped rows, at budgets inside and
  past one round.
"""

import os
import re

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.ops import latency_cuda
from apda_fft_tpu_torch.ops import peaks_prominence as tprom
from apda_fft_tpu_torch.utils import kernels

BLOCK_SMEM = 227 * 1024  # bytes of shared memory a block may use on Hopper


def _constant(source: str, name: str) -> int:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        text = f.read()
    expr = re.search(rf"constexpr \w+ {name} = ([0-9 *+\-]+);", text).group(1)
    return int(eval(expr))  # a constant expression of integers from the source


SMEM_CAP = _constant("lowlat_window.cu", "kSmemCap")
SLOTS = _constant("lowlat_window.cu", "kSlots")
MAX_LIST = _constant("walk_common.cuh", "kMaxList")


def layout(n: int) -> dict:
    """``layout()`` of lowlat_window.cu, the same for both kernels."""
    h = n // 2
    out = {"smem": 0, "ws": 0, "mags_smem": False, "fft_smem": False, "list_cap": 0}
    if 4 * h <= SMEM_CAP:
        out["smem"] = 4 * h
        out["mags_smem"] = True
    else:
        out["ws"] = h
    out["smem"] += 8 * ((h + 31) // 32)
    full = min(h // 4 + 2, MAX_LIST) & ~1
    padded = h + (h >> 4)
    if out["smem"] + 8 * full + 16 * padded <= SMEM_CAP:
        out["smem"] += 16 * padded
        out["fft_smem"] = True
    else:
        out["ws"] += 4 * padded
    room = max(SMEM_CAP - out["smem"], 0) // 8
    out["list_cap"] = min(full, room) & ~1
    out["smem"] += 8 * out["list_cap"]
    return out


LENGTHS = [1 << p for p in range(6, latency_cuda.LOWLAT_MAX_N.bit_length())]


def test_lengths_cover_the_route():
    assert LENGTHS[0] == 64 and LENGTHS[-1] == latency_cuda.LOWLAT_MAX_N == 65536


def _static_scratch_bytes(kernel: str) -> int:
    """Bytes of the kernel's static shared arrays: the reduction scratch of
    32 warps (4 + 4 + 8 + 8 bytes a warp) and its ``__shared__`` arrays and
    scalars, read from the source."""
    with open(os.path.join(kernels.CSRC_DIR, "lowlat_window.cu")) as f:
        text = f.read()
    body = text[text.index(f"{kernel}("):]
    body = body[:body.index("const int tid")]
    sizes = {"kSlots": SLOTS, "kAccepted": _constant("lowlat_window.cu", "kAccepted")}
    total = 32 * (4 + 4 + 8 + 8)
    for decl in re.findall(r"__shared__ (?:int|float) ([^;]+);", body):
        for name in decl.split(","):
            m = re.search(r"\[(\w+)\]", name)
            total += 4 * (sizes[m.group(1)] if m else 1)
    return total


@pytest.mark.parametrize("rigid", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_shared_part_fits_and_holds_the_magnitudes(n, rigid):
    lay = layout(n)
    assert lay["mags_smem"]
    # The static scratch (reductions, pick slots) stays inside the 2 KB kept.
    assert SMEM_CAP == BLOCK_SMEM - 2048
    kernel = "lowlat_rigid_kernel" if rigid else "lowlat_flexible_kernel"
    assert _static_scratch_bytes(kernel) <= 2048
    assert lay["smem"] + 2048 <= BLOCK_SMEM
    h = n // 2
    assert lay["list_cap"] == min(h // 4 + 2, MAX_LIST) & ~1  # every candidate fits
    assert lay["fft_smem"] == (n <= 16384)
    assert lay["ws"] == (0 if n <= 16384 else 4 * (h + (h >> 4)))
    # The rigid kernel keeps its unwiped magnitudes in the free FFT buffer.
    assert 2 * (h + (h >> 4)) >= h


def kernel_finalize(cid, cmag, prom, bins, fs, n_fft, k, std, n_cand, m):
    """The flexible kernel's finalize for one window: rounds of SLOTS picks,
    walked in order by one thread, stopping at the k-th acceptance, in the
    kernel's float32 operations."""
    f32 = np.float32
    ds = f32(f32(fs) / f32(n_fft))
    half_sd = f32(f32(0.5) * f32(std))

    def round_dec(v, scale):
        return f32(f32(np.rint(f32(v * scale))) / scale)

    live = min(n_cand, m)
    count, consumed, idx, freqs = 0, 0, [], []
    for lo in range(0, live, SLOTS):
        for r in range(lo, min(live, lo + SLOTS)):
            if count >= k:
                break
            consumed += 1
            j, b = int(cid[r]), int(bins[r])
            width = f32(f32(b) * ds)
            fn = f32(f32(j) * ds)
            q = f32(fn / width)
            valid = prom[r] > half_sd and width > 0 and 500 * b >= j and 50 * b <= 7 * j
            freq_r = round_dec(fn, f32(1e4))
            mag_r = round_dec(cmag[r], f32(1e4))
            ratio = f32(prom[r] / mag_r) if mag_r > 0 else f32(0)
            near = any(f32(abs(f32(freq_r - f2)) / (f2 if f2 != 0 else f32(1))) < f32(0.05)
                       for f2 in freqs)
            if valid and not (near and ratio < f32(0.10)):
                idx.append(j)
                freqs.append(freq_r)
                count += 1
        if count >= k:
            break
    return count, idx, consumed if count >= k else n_cand


def _rows(kind: str, h: int, seed: int) -> np.ndarray:
    """Noise, modal (a few damped-mode bumps on low noise), or overflow-shaped
    rows: one-bin spikes above bin 1000, which all fail the damping floor, so
    the walk never completes."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "noise":
        x = rng.random((6, h)) * 5.0
    elif kind == "modal":
        x = 0.2 * rng.random((6, h))
        for row in x:
            for c in rng.uniform(20, h - 20, 6):
                row += rng.uniform(2, 30) * np.exp(-0.5 * ((bins - c) / rng.uniform(1, 8)) ** 2)
    else:
        x = 0.05 * rng.random((6, h))
        for row in x:
            spikes = np.arange(1001, 1001 + 3 * rng.integers(70, 100), 3)
            row[spikes] = rng.uniform(3.0, 5.0, spikes.size)
    x[:, 0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("m", [2, 8, 64, 128])
@pytest.mark.parametrize("kind", ["noise", "modal", "overflow"])
def test_ordered_finalize_equals_prominence_finalize(kind, m):
    h, n_fft, fs, k = 2048, 4096, 500.0, 4
    mags = torch.from_numpy(_rows(kind, h, seed=m + len(kind)))
    cid, is_cand, cmag, _, std, n_cand = tprom.prominence_select(mags, m)
    prom, bins = tprom._prominence_and_width(mags, cid, cmag)
    want = tprom.prominence_finalize(cid, is_cand, cmag, prom, bins, fs, n_fft, k, std, n_cand)
    for r in range(mags.shape[0]):
        count, idx, n_required = kernel_finalize(
            cid[r].numpy(), cmag[r].numpy(), prom[r].numpy(), bins[r].numpy(), fs, n_fft, k,
            std[r].numpy(), int(n_cand[r]), m)
        assert count == int(want.count[r]), (r, count)
        assert idx == want.idx[r, :count].tolist(), r
        assert n_required == int(want.n_required[r]), (r, n_required)
    if kind == "overflow":
        assert (want.count < k).all() and (want.n_required == n_cand).all()
        assert int(n_cand.min()) > 64  # past one round of picks
