"""Resolution-based peak detector ("rigid structures" mode), batched.

Counterpart of ``apda_fft_tpu/ops/peaks_resolution.py``: the reference's
destructive greedy loop (``utils/get_peak_resolution.py:80-128``) as masked
rounds over a ``[B, H]`` batch.  Each round picks every unfinished window's
highest strict local maximum above the (fixed) threshold, first index on
ties; accepts it when it is Rayleigh-separated from every accepted peak
(``1.18*|di|/w_new >= 1.5``, the accepted peaks' own widths being 0 on the
wiped spectrum); and zeroes ``round(f*0.02/df)`` bins on each side of it
either way.  A window is done at k peaks or when no candidate is left.

Rounds run on the device; the host reads ``done.all()`` once every
``_ROUNDS_PER_CHECK`` rounds, not once per round.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from apda_fft_tpu_torch.ops.stats import div_exact, noise_threshold

RESOLUTION_NORMALIZATION = 1.18
RESOLUTION_MIN = 1.5
EXCLUSION_FRACTION = 0.02

#: Masked rounds between two host reads of the batch's done flags.
_ROUNDS_PER_CHECK = 4


class ResolutionPeaks(NamedTuple):
    """Top-k resolved peaks per window (fixed k slots, ``count`` valid)."""

    count: torch.Tensor  # [B] int32
    idx: torch.Tensor  # [B, k] int32, bin index (-1 for empty slots)
    freq: torch.Tensor  # [B, k] unrounded idx * fs/n
    mag: torch.Tensor  # [B, k] magnitude at pick time
    n_candidates: torch.Tensor  # [B] int32: initial local maxima above threshold


def _discard_count(freq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """``round(freq * 0.02 / df)`` with float64-faithful rounding at halves.

    The float64 reference lands exactly on half-integers for dyadic rates;
    float32 lands an ulp away, so values within 1e-3 of a half snap to it
    before the half-to-even rounding.
    """
    x = freq * EXCLUSION_FRACTION / ds
    doubled = x + x
    nearest = torch.round(doubled)
    near_half = (doubled - nearest).abs() < 1e-3
    snapped = torch.where(near_half, nearest * 0.5, x)
    return torch.round(snapped).to(torch.int32)


def rigid_half_corrections(fs: float, n_fft: int) -> np.ndarray | None:
    """Host float64 wipe-width corrections for ``idx % 50 == 25`` boundaries.

    The reference wipe width is ``round((idx*df)*0.02/df)`` in float64; in
    exact arithmetic ``idx/50``, a half-integer iff ``idx % 50 == 25``.  For
    non-dyadic ``fs`` the float64 roundings move that half by an ulp in a
    direction float32 cannot reproduce; this returns, per boundary index,
    the true float64 rounding minus the device's banker's rounding of the
    exact half.  An int8 array indexed by ``idx // 50``, or None when every
    entry is zero (the dyadic case).  ``fs`` is the original float64 rate.
    """
    h = n_fft // 2
    if h <= 25:
        return None
    ds = np.float64(fs) / np.float64(n_fft)
    j = np.arange(25, h, 50, dtype=np.float64)
    nd64 = np.round(((j * ds) * np.float64(EXCLUSION_FRACTION)) / ds)
    q = np.round((j - 25.0) / 50.0)
    base = q + (q % 2)  # banker's rounding of the exact half q + 0.5
    corr = (nd64 - base).astype(np.int8)
    return corr if corr.any() else None


@functools.lru_cache(maxsize=256)
def _half_corrections(fs: float, n_fft: int) -> np.ndarray | None:
    """:func:`rigid_half_corrections`, computed once per ``(fs, n_fft)``;
    the table is shared, so it is read-only."""
    c = rigid_half_corrections(fs, n_fft)
    if c is not None:
        c.flags.writeable = False
    return c


def rigid_corr_batch(fs, lead, n_fft: int) -> np.ndarray | None:
    """Per-window non-dyadic wipe-rounding tables ``[*lead, ceil(H/50)]``
    int8 from the ORIGINAL float64 rates ``fs`` (a tensor, array or scalar,
    before any cast), or None when every table is empty (the dyadic case)."""
    if isinstance(fs, torch.Tensor):
        fs = fs.detach().cpu().double().numpy()
    fs_host = np.asarray(fs, np.float64)
    h = n_fft // 2
    hq = len(range(25, h, 50))
    if hq == 0:
        return None
    fs_host = np.broadcast_to(fs_host, lead).reshape(-1)
    tables: dict[float, np.ndarray | None] = {}
    out = None
    for i, v in enumerate(fs_host):
        key = float(v)
        if key not in tables:
            tables[key] = _half_corrections(key, n_fft)
        c = tables[key]
        if c is not None:
            if out is None:
                out = np.zeros((fs_host.size, hq), np.int8)
            out[i] = c
    return out.reshape(tuple(lead) + (hq,)) if out is not None else None


def resolution_peaks(
    mags: torch.Tensor,
    fs,
    n_fft: int,
    k: int = 5,
    half_corr: torch.Tensor | None = None,
) -> ResolutionPeaks:
    """Top-k resolution-separated peaks of each half-spectrum in ``mags [B, H]``.

    ``fs`` is a scalar or ``[B]``; ``half_corr`` the optional ``[B, ceil(H/50)]``
    :func:`rigid_half_corrections` tables for non-dyadic rates.
    """
    b, h = mags.shape
    dtype, device = mags.dtype, mags.device
    fs = torch.as_tensor(fs, dtype=dtype, device=device).broadcast_to((b,))
    ds = div_exact(fs, float(n_fft))
    iota = torch.arange(h, device=device)
    slots = torch.arange(k, device=device)
    interior = (iota >= 1) & (iota <= h - 2)

    thr, _ = noise_threshold(mags)
    thr = thr[:, None]

    def local_max(m):
        return interior & (m > torch.roll(m, 1, dims=-1)) & (m > torch.roll(m, -1, dims=-1))

    n_cand = (local_max(mags) & (mags > thr)).sum(dim=-1).to(torch.int32)

    m = mags.clone()
    count = torch.zeros(b, dtype=torch.int32, device=device)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=device)
    mag = torch.zeros((b, k), dtype=dtype, device=device)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    if half_corr is not None:
        half_corr = torch.as_tensor(half_corr, device=device).to(torch.int32)
        hq = half_corr.shape[-1]

    rounds = 0
    while b and not (rounds % _ROUNDS_PER_CHECK == 0 and bool(done.all())):
        rounds += 1
        live = ~done
        eligible = local_max(m) & (m > thr)
        found = eligible.any(dim=-1)
        score = torch.where(eligible, m, -torch.inf)
        peak_val = score.amax(dim=-1)
        j = torch.where(score == peak_val[:, None], iota, h).amin(dim=-1)

        # Reference width_half_magnitude on the current spectrum: nearest
        # index at or below 0.707*peak on each side (left defaults to 0,
        # right to H).  Accepted peaks' own widths are 0 on the wiped
        # spectrum, so the Rayleigh sum is w_new alone.
        half = 0.707 * peak_val
        at_or_below = m <= half[:, None]
        w_left = torch.where((iota <= j[:, None]) & at_or_below, iota, 0).amax(dim=-1)
        w_right = torch.where((iota >= j[:, None]) & at_or_below, iota, h).amin(dim=-1)
        wsum = (w_right - w_left).to(dtype)[:, None].expand(b, k)
        di = (idx - j[:, None].to(torch.int32)).abs().to(dtype)
        rs = torch.where(wsum != 0, RESOLUTION_NORMALIZATION * di / wsum, 0.0)
        separated = (~(slots < count[:, None]) | (rs >= RESOLUTION_MIN)).all(dim=-1)

        take = live & found & separated
        write = take[:, None] & (slots == count[:, None])
        idx = torch.where(write, j[:, None].to(torch.int32), idx)
        mag = torch.where(write, peak_val[:, None], mag)
        count = count + take.to(torch.int32)

        nd = _discard_count(j.to(dtype) * ds, ds)
        if half_corr is not None:
            q = torch.clamp(j // 50, max=hq - 1)
            corr = torch.gather(half_corr, 1, q[:, None])[:, 0]
            nd = torch.where(j % 50 == 25, nd + corr, nd)
        start = torch.clamp(j - nd, min=0)
        end = torch.clamp(j + nd + 1, max=h)
        wipe = (live & found)[:, None] & (iota >= start[:, None]) & (iota < end[:, None])
        m = torch.where(wipe, zero, m)
        done = done | ~found | (count >= k)

    freq = torch.where(idx >= 0, idx.to(dtype) * ds[:, None], 0.0)
    return ResolutionPeaks(count=count, idx=idx, freq=freq, mag=mag, n_candidates=n_cand)
