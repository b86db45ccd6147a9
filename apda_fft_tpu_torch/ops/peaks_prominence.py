"""Prominence-based peak detector ("flexible structures" mode), batched.

Counterpart of ``apda_fft_tpu/ops/peaks_prominence.py``, written over a
``[B, H]`` batch of half-spectra instead of one window under ``vmap``.  The
reference semantics are the same (``utils/get_peak_prominence.py:149-226``):

* threshold ``mean + 2*stdev`` (ddof=1) over the magnitudes, DC bin included;
* candidates are strict interior local maxima above it;
* prominence is the peak minus the higher of its two flanking valleys, each
  valley scan stopping at the first strictly higher sample;
* candidates need ``prominence > 0.5*stdev``, a -3 dB width (at
  ``valley + 0.707*prominence``) of at least one bin, and damping in
  [0.1%, 7%];
* candidates are walked in 4-dp-rounded-magnitude order (ties by ascending
  bin) with greedy shoulder rejection up to k peaks;
* stored values are rounded like the reference (freq/mag 4 dp, damping in %
  and Q 2 dp), half to even.

The detector pre-selects the first ``max_candidates`` candidates of that
order; ``n_candidates`` and ``n_required`` report what the budget needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apda_fft_tpu_torch.ops.stats import div_exact, noise_threshold

MIN_DAMPING = 0.001
MAX_DAMPING = 0.07
EXCLUSION_RATIO = 0.05
MIN_PROM_RATIO = 0.10

#: Budgets up to this size run the greedy finalize as a per-candidate walk;
#: larger budgets use the slot-wise k-round form (identical decisions, see
#: prominence_finalize).  Patchable in tests to force either form.
_UNROLL_MAX = 8

#: Elements of one [b, M, H] scan chunk: bounds the plain scans' memory.
_SCAN_CHUNK_ELEMS = 1 << 24


class ProminencePeaks(NamedTuple):
    """Top-k peaks per window (fixed k slots, ``count`` of them valid)."""

    count: torch.Tensor  # [B] int32
    idx: torch.Tensor  # [B, k] int32, bin index (-1 for empty slots)
    freq: torch.Tensor  # [B, k] rounded to 4 decimals
    mag: torch.Tensor  # [B, k] rounded to 4 decimals
    prominence: torch.Tensor  # [B, k] unrounded
    damping: torch.Tensor  # [B, k] percent, rounded to 2 decimals
    q_factor: torch.Tensor  # [B, k] rounded to 2 decimals
    n_candidates: torch.Tensor  # [B] int32: local maxima above threshold (pre-budget)
    n_required: torch.Tensor  # [B] int32: smallest budget that decides the window exactly


def _round_decimals(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """Python's round(x, d) (half to even, as ``torch.round`` does)."""
    scale = torch.full((), 10.0**decimals, dtype=x.dtype, device=x.device)
    return torch.round(x * scale) / scale


def _candidate_mask(mags: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Strict interior local maxima above the per-row threshold ``thr [B]``."""
    h = mags.shape[-1]
    iota = torch.arange(h, device=mags.device)
    interior = (iota >= 1) & (iota <= h - 2)
    local_max = (
        interior
        & (mags > torch.roll(mags, 1, dims=-1))
        & (mags > torch.roll(mags, -1, dims=-1))
    )
    return local_max & (mags > thr[..., None])


def prominence_select(mags: torch.Tensor, max_candidates: int):
    """Threshold, local maxima and the magnitude-ordered candidate slots.

    ``mags [B, H]`` -> ``(cid, is_cand, cmag, threshold, std, n_candidates)``
    with ``[B, M]`` slots, ``M = min(max_candidates, H)``.  Slots follow the
    reference's walk order: 4-dp-rounded magnitude descending, ties by
    ascending bin (a stable sort on the negated score; ``torch.topk`` leaves
    the tie order unspecified).  Slots past a row's candidates hold bin 0
    with its magnitude and ``is_cand`` False - the fill an argmax over an
    exhausted score gives, which the fused kernel reproduces.
    """
    h = mags.shape[-1]
    thr, std = noise_threshold(mags)
    cand_mask = _candidate_mask(mags, thr)
    eff = min(max_candidates, h)
    score = torch.where(cand_mask, _round_decimals(mags, 4), -torch.inf)
    neg_sorted, order = torch.sort(-score, dim=-1, stable=True)
    is_cand = neg_sorted[..., :eff] < torch.inf
    cid = torch.where(is_cand, order[..., :eff], 0).to(torch.int32)
    cmag = torch.gather(mags, -1, cid.long())
    n_cand = cand_mask.sum(dim=-1).to(torch.int32)
    return cid, is_cand, cmag, thr, std, n_cand


def _prominence_and_width(mags: torch.Tensor, cid: torch.Tensor, peak: torch.Tensor):
    """Prominence and -3 dB width in bins for every slot of ``cid [B, M]``.

    Masked-reduction forms of the reference's scan loops over ``[b, M, H]``
    chunks of the batch.  Prominence: each side's valley is the minimum over
    the open interval between the peak and its nearest blocker (a sample
    above the peak), or the peak itself when that interval is empty.  Width:
    the nearest index on each side where ``mag <= valley + 0.707*prom`` or
    ``mag > peak`` (clamped to [0, H-1]).
    """
    b, h = mags.shape
    m = cid.shape[-1]
    iota = torch.arange(h, device=mags.device)
    step = max(1, _SCAN_CHUNK_ELEMS // max(m * h, 1))
    proms, bins = [], []
    for lo in range(0, b, step):
        x = mags[lo:lo + step, None, :]
        j = cid[lo:lo + step, :, None]
        pk = peak[lo:lo + step, :, None]
        left = iota < j
        right = iota > j
        blocker = x > pk
        last_blk_left = torch.where(blocker & left, iota, -1).amax(-1, keepdim=True)
        first_blk_right = torch.where(blocker & right, iota, h).amin(-1, keepdim=True)
        min_left = torch.minimum(
            pk, torch.where((iota > last_blk_left) & left, x, torch.inf).amin(-1, keepdim=True)
        )
        min_right = torch.minimum(
            pk, torch.where((iota < first_blk_right) & right, x, torch.inf).amin(-1, keepdim=True)
        )
        prom = pk - torch.maximum(min_left, min_right)
        valley = pk - prom
        target = valley + prom * 0.707
        stop = (x <= target) | (x > pk)
        left_idx = torch.where(stop & (iota <= j), iota, 0).amax(-1)
        right_idx = torch.where(stop & (iota >= j), iota, h - 1).amin(-1)
        proms.append(prom[..., 0])
        bins.append(torch.clamp(right_idx - left_idx, min=1).to(torch.int32))
    if not proms:
        return torch.zeros_like(peak), torch.ones_like(cid)
    return torch.cat(proms), torch.cat(bins)


def prominence_finalize(cid, is_cand, cmag, proms, bins, fs, n_fft: int, k: int, std,
                        n_candidates=None) -> ProminencePeaks:
    """Physics filters, reference rounding and greedy shoulder rejection.

    Slot inputs are ``[B, M]``; ``fs`` and ``std`` are ``[B]`` (or scalars).
    """
    dtype = cmag.dtype
    device = cmag.device
    b, m_slots = cid.shape
    fs = torch.as_tensor(fs, dtype=dtype, device=device).broadcast_to((b,))
    std = torch.as_tensor(std, dtype=dtype, device=device).broadcast_to((b,))
    ds = div_exact(fs, float(n_fft))[:, None]
    width = bins.to(dtype) * ds
    fn = cid.to(dtype) * ds
    q = fn / width
    damping = torch.ones_like(q) / (2.0 * q)

    # Damping band as exact integer comparisons: damping = bins/(2*idx), so
    # d >= 1/1000 <=> 500*bins >= idx and d <= 7/100 <=> 50*bins <= 7*idx
    # (the f32 compare flips at exact boundaries).
    bins_i = bins.to(torch.int32)
    cid_i = cid.to(torch.int32)
    valid = (
        is_cand
        & (proms > 0.5 * std[:, None])
        & (width > 0)
        & (500 * bins_i >= cid_i)
        & (50 * bins_i <= 7 * cid_i)
    )

    freq_r = _round_decimals(fn, 4)
    mag_r = _round_decimals(cmag, 4)
    damp_r = _round_decimals(damping * 100.0, 2)
    q_r = _round_decimals(q, 2)
    # A magnitude that rounds to 0 would divide by zero in the reference
    # (which then drops the whole window); here its ratio is 0, so it is a
    # shoulder whenever it sits near an accepted peak.
    pos = mag_r > 0
    prom_ratio = torch.where(pos, proms / torch.where(pos, mag_r, 1.0), 0.0)
    shoulder = prom_ratio < MIN_PROM_RATIO
    fields = {"idx": cid_i, "freq": freq_r, "mag": mag_r, "prom": proms,
              "damp": damp_r, "q": q_r}

    acc = {
        "idx": torch.full((b, k), -1, dtype=torch.int32, device=device),
        **{f: torch.zeros((b, k), dtype=dtype, device=device)
           for f in ("freq", "mag", "prom", "damp", "q")},
    }
    slots = torch.arange(k, device=device)
    count = torch.zeros(b, dtype=torch.int32, device=device)

    def near_accepted(freq, filled):
        """[B, ...] mask: ``freq`` within EXCLUSION_RATIO of an accepted peak."""
        f2 = acc["freq"]
        denom = torch.where(f2 != 0, f2, 1.0)
        extra = (1,) * (freq.dim() - 1)
        rel = (freq[:, None] - f2.view(b, k, *extra)).abs() / denom.view(b, k, *extra)
        return ((rel < EXCLUSION_RATIO) & filled.view(b, k, *extra)).any(dim=1)

    if m_slots <= _UNROLL_MAX:
        # The reference's walk, one candidate at a time.  `consumed` counts
        # slots examined while the walk was incomplete: once count hits k the
        # reference breaks, so later candidates are decision-irrelevant.
        consumed = torch.zeros_like(count)
        for i in range(m_slots):
            open_ = count < k
            consumed = consumed + open_.to(torch.int32)
            near = near_accepted(freq_r[:, i], slots < count[:, None])
            take = valid[:, i] & open_ & ~(near & shoulder[:, i])
            write = take[:, None] & (slots == count[:, None])
            for f, v in fields.items():
                acc[f] = torch.where(write, v[:, i, None], acc[f])
            count = count + take.to(torch.int32)
    else:
        # Slot-wise form: a candidate's rejection depends only on the peaks
        # accepted so far, so accepted[s] is the FIRST candidate after
        # accepted[s-1] that is valid and not a shoulder of accepted[0..s-1]
        # - k rounds of [B, M] ops instead of M sequential steps.
        cand_pos = torch.arange(m_slots, device=device)
        prev_pos = torch.full((b,), -1, dtype=torch.int64, device=device)
        filled = torch.zeros((b, k), dtype=torch.bool, device=device)
        for s in range(k):
            near = near_accepted(freq_r, filled)
            eligible = (cand_pos > prev_pos[:, None]) & valid & ~(near & shoulder)
            found = eligible.any(dim=-1)
            j = torch.where(eligible, cand_pos, m_slots).amin(dim=-1)
            jj = j.clamp(max=m_slots - 1)[:, None]
            for f, v in fields.items():
                acc[f][:, s] = torch.where(found, torch.gather(v, 1, jj)[:, 0], acc[f][:, s])
            filled[:, s] = found
            prev_pos = torch.where(found, j, m_slots)
            count = count + found.to(torch.int32)
        # Walk completed: the k-th acceptance sits at prev_pos and the
        # reference breaks right after it.
        consumed = (prev_pos + 1).to(torch.int32)

    if n_candidates is None:
        n_candidates = torch.zeros_like(count)
    # Completed walk: `consumed` slots of the reference's order decided the
    # top-k.  Incomplete walk: every pre-budget candidate must be seen.
    n_required = torch.where(count >= k, consumed, n_candidates.to(torch.int32))
    return ProminencePeaks(
        count=count,
        idx=acc["idx"],
        freq=acc["freq"],
        mag=acc["mag"],
        prominence=acc["prom"],
        damping=acc["damp"],
        q_factor=acc["q"],
        n_candidates=n_candidates.to(torch.int32),
        n_required=n_required,
    )


def prominence_peaks(
    mags: torch.Tensor,
    fs,
    n_fft: int,
    k: int = 4,
    max_candidates: int = 32,
    selection: str = "auto",
) -> ProminencePeaks:
    """Top-k prominent peaks of each half-spectrum in ``mags [B, H]``.

    ``fs`` is the sampling rate, a scalar or ``[B]``.  ``selection`` accepts
    only ``"auto"``: the port has one order-exact selection.
    """
    if selection != "auto":
        raise ValueError(f"unknown selection {selection!r}; the port has only 'auto'")
    cid, is_cand, cmag, _, std, n_cand = prominence_select(mags, max_candidates)
    proms, bins = _prominence_and_width(mags, cid, cmag)
    return prominence_finalize(cid, is_cand, cmag, proms, bins, fs, n_fft, k, std, n_cand)
