"""Streams, spectrograms, Welch averaging and cross spectra.

Counterpart of ``apda_fft_tpu/models/streaming.py``.  Continuous per-channel
records ``[..., T]`` are framed into (overlapping) windows and analysed as
one epoch (:func:`analyze_stream`, BASELINE config 4), turned into
magnitude spectrograms, Welch power spectral densities and Welch-averaged
peak lists (:func:`analyze_welch`), or paired into cross spectra and
coherence.  :func:`analyze_epochs_pipelined` keeps several epochs in flight
with the dynamic budget's check deferred.

Every entry point runs where ``analyze_epoch`` would: a tensor on its own
device, an array or list on the card unless ``device="cpu"`` is given
(without a card an array raises ``RuntimeError``).  On the card the segment
spectra of ``backend="pallas"`` run the fused front-end kernel and every
flexible detect pass the select+scan kernel.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from apda_fft_tpu_torch.models import budget as _budget
from apda_fft_tpu_torch.models import pipeline as _pipeline
from apda_fft_tpu_torch.models.pipeline import analyze_epoch
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops import fft as fft_ops
from apda_fft_tpu_torch.ops.peaks_prominence import check_selection
from apda_fft_tpu_torch.ops.peaks_resolution import rigid_corr_batch
from apda_fft_tpu_torch.ops.stats import div_exact
from apda_fft_tpu_torch.utils.placement import fs_tensor, from_host, placed

DETRENDS = ("median", "mean")


def frame_records(records, window: int, hop: int, *,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Frame ``[..., T]`` records into ``[..., W, window]`` windows, a view.

    W = floor((T - window) / hop) + 1; windows may overlap (hop < window).
    ``records.unfold`` gives the windows the JAX package builds by reshape,
    stacked slices, phase decomposition or gather, without a copy.  A
    tensor is framed where it lies (or moved to ``device``); an array or
    list goes to ``device``, by default the card, as in ``analyze_epoch``.
    """
    records = placed(records, device)
    t = records.shape[-1]
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window > t:
        raise ValueError(f"window {window} longer than record {t}")
    if hop < 1:
        raise ValueError("hop must be >= 1")
    return records.unfold(-1, window, hop)


def analyze_stream(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    device: torch.device | str | None = None,
    **kwargs,
) -> EpochResult:
    """Frame ``[C, T]`` (or ``[T]``) records and analyze every window.

    Returns an :class:`EpochResult` with batch shape ``[C, W]`` (or ``[W]``).
    ``kwargs`` pass through to :func:`analyze_epoch` (mode, backend, k, ...).
    """
    records = placed(records, device, kwargs.get("dtype", torch.float32))
    hop = window if hop is None else hop
    return analyze_epoch(frame_records(records, window, hop), fs, **kwargs)


def _bin_freqs(fs, n_fft: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Half-spectrum bin frequencies; per-channel fs broadcasts to [..., H]."""
    fs_t = fs_tensor(fs, dtype, device)
    freqs = torch.arange(n_fft // 2, dtype=dtype, device=device) * div_exact(
        fs_t[..., None], float(n_fft))
    return freqs.reshape(-1) if fs_t.dim() == 0 else freqs


def _taper_power_sum(name: str, window: int) -> float:
    """sum(w_norm**2) of the coherent-gain-normalized taper, float64 on the host."""
    w = {"hann": np.hanning, "hamming": np.hamming, "blackman": np.blackman}[name](window)
    w = w / w.mean()
    return float(np.sum(w * w))


def _density_scale(fs, window: int, taper: str, dtype, device) -> torch.Tensor:
    """One-sided density scaling ``2 / (fs * sum(w^2))``, ``[..., 1]``."""
    wsum2 = float(window) if taper == "none" else _taper_power_sum(taper, window)
    fs_t = fs_tensor(fs, dtype, device)
    return torch.full((), 2.0, dtype=dtype, device=device) / (fs_t[..., None] * wsum2)


def _segment_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the segment axis (-2), as a correctly rounded division."""
    return div_exact(x.sum(dim=-2), float(x.shape[-2]))


def _check(taper: str, detrend: str) -> None:
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")


def _segment_front_end(records: torch.Tensor, *, window, hop, taper, detrend):
    """Frame -> detrend -> pad -> taper: flat segments ``[B, n_fft]`` + lead shape.

    The one implementation behind :func:`_segment_mags` (magnitudes) and
    :func:`_segment_spectra` (complex spectra).
    """
    if window < 2:
        raise ValueError(f"window must be >= 2, got {window}")
    framed = frame_records(records, window, hop)
    n_fft = fft_ops.next_pow2(window)
    lead = framed.shape[:-1]
    flat = framed.reshape(-1, window)
    if detrend == "mean":
        segs = flat - div_exact(flat.sum(dim=-1, keepdim=True), float(window))
        if window < n_fft:
            segs = torch.nn.functional.pad(segs, (0, n_fft - window))
    else:
        segs = fft_ops.center_and_pad(flat, n_fft, None)
    if taper != "none":
        # The taper spans the window's samples and is zero over the pad.
        span = torch.full((), window, device=segs.device) if window < n_fft else None
        segs = segs * fft_ops.taper_window(taper, n_fft, segs.dtype, span, device=segs.device)
    return segs, lead


def _segment_mags(records: torch.Tensor, *, window, hop, taper, backend, detrend="median",
                  precision="highest") -> torch.Tensor:
    """Frame -> detrend -> taper -> half-spectrum magnitudes ``[..., W, H]``.

    The shared segment front end of :func:`spectrogram`,
    :func:`analyze_welch` and :func:`welch_psd`.  ``detrend="median"`` is
    the reference front end's centering; ``"mean"`` the scipy/Welch
    convention (the two differ only in the DC-adjacent bins the taper's
    leakage reaches; DC itself is always zeroed).
    """
    segs, lead = _segment_front_end(records, window=window, hop=hop, taper=taper,
                                    detrend=detrend)
    mags = fft_ops.halfspec_magnitudes(segs, backend=backend, precision=precision)
    return mags.reshape(lead + (mags.shape[-1],))


def spectrogram(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "none",
    backend: str = "matmul",
    dtype: torch.dtype = torch.float32,
    detrend: str = "median",
    precision: str = "highest",
    device: torch.device | str | None = None,
):
    """Magnitude spectrogram of ``[..., T]`` records: ``(freqs, mags)``.

    Frames records (``hop`` defaults to ``window``, non-overlapping),
    detrends each segment (``"median"`` the reference front end,
    ``"mean"`` the scipy convention; DC zeroed either way), optionally
    tapers, and returns ``mags[..., W, H]`` with the bin frequencies
    ``freqs[H]`` (``[C, H]`` for per-channel rates) in Hz.
    """
    records = placed(records, device, dtype)
    hop = window if hop is None else hop
    _check(taper, detrend)
    n_fft = fft_ops.next_pow2(window)
    mags = _segment_mags(records, window=window, hop=hop, taper=taper, backend=backend,
                         detrend=detrend, precision=precision)
    return _bin_freqs(fs, n_fft, dtype, records.device), mags


def welch_psd(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    backend: str = "matmul",
    dtype: torch.dtype = torch.float32,
    detrend: str = "mean",
    precision: str = "highest",
    device: torch.device | str | None = None,
):
    """One-sided Welch power spectral density: ``(freqs, psd)``.

    Units ``input_units^2 / Hz``, matching ``scipy.signal.welch`` with the
    same symmetric window and segmenting and ``detrend="mean"``
    (``"median"``, the reference front end's centering, differs only near
    DC).  The DC bin is zeroed; ``psd`` is ``[..., H]``; ``hop`` defaults to
    50% overlap.
    """
    records = placed(records, device, dtype)
    hop = max(window // 2, 1) if hop is None else hop
    _check(taper, detrend)
    n_fft = fft_ops.next_pow2(window)
    mags = _segment_mags(records, window=window, hop=hop, taper=taper, backend=backend,
                         detrend=detrend, precision=precision)
    # The segments were tapered with w/mean(w): undo that and apply the
    # one-sided density scaling 2/(fs*sum(w^2)).  (H = n_fft/2 leaves out
    # the Nyquist bin; DC is zeroed, so its factor-2 excess is moot.)
    psd = _segment_mean(mags * mags) * _density_scale(fs, window, taper, dtype,
                                                      records.device)
    return _bin_freqs(fs, n_fft, dtype, records.device), psd


def analyze_welch(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    mode: str = "flexible",
    k: int | None = None,
    backend: str = "matmul",
    max_candidates: int | None = None,
    refine: bool = False,
    dtype: torch.dtype = torch.float32,
    selection: str = "auto",
    detrend: str = "mean",
    precision: str = "highest",
    device: torch.device | str | None = None,
) -> EpochResult:
    """Welch-averaged spectral peak detection over long records.

    Frame ``[C, T]`` (or ``[T]``) records into ``W`` (optionally
    overlapping) segments, detrend and taper each, average the segment
    power spectra, and run the detector once per channel on the
    RMS-averaged magnitude spectrum ``sqrt(mean(|X|^2))``.  Returns an
    :class:`EpochResult` with batch shape ``[C]`` (or ``[]`` for ``[T]``).

    ``hop`` defaults to ``window // 2``.  ``max_candidates`` defaults to the
    static ``default_max_candidates(n_fft)`` (averaged spectra are smooth;
    pass a larger int if ``result.n_candidates`` reports overflow): there is
    no dynamic budget and no readback here.
    """
    fs_orig = fs  # pre-cast rate (rigid non-dyadic wipe rounding)
    records = placed(records, device, dtype)
    hop = max(window // 2, 1) if hop is None else hop
    n_fft = fft_ops.next_pow2(window)
    if mode not in _pipeline.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check(taper, detrend)
    if precision not in fft_ops.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {fft_ops.PRECISIONS}"
        )
    if precision == "fast" and backend != "matmul":
        raise ValueError(
            'precision="fast" applies to the matmul backend only '
            f"(got backend={backend!r})"
        )
    check_selection(selection)
    if k is None:
        k = _pipeline.default_k(mode)
    if max_candidates is None:
        max_candidates = _pipeline.default_max_candidates(n_fft)
    dev = records.device
    lead = records.shape[:-1]
    half_corr = None
    if mode in ("rigid", "adaptive"):
        table = rigid_corr_batch(fs_orig, lead, n_fft)
        if table is not None:
            half_corr = from_host(table.reshape(-1, table.shape[-1]), dev)

    mags = _segment_mags(records, window=window, hop=hop, taper=taper, backend=backend,
                         detrend=detrend, precision=precision)      # [..., W, H]
    # Welch: average segment POWER, report RMS magnitude (the scale of one
    # segment's spectrum; the zeroed DC bin stays zero).
    avg = torch.sqrt(_segment_mean(mags * mags))                    # [..., H]
    fs_flat = fs_tensor(fs, dtype, dev).broadcast_to(lead).reshape(-1)
    res = _pipeline._detect_from_mags(
        avg.reshape(-1, avg.shape[-1]), fs_flat, n_fft=n_fft, mode=mode, k=k,
        max_candidates=max_candidates, refine=refine, half_corr=half_corr,
    )
    return EpochResult(*(x.reshape(lead + x.shape[1:]) for x in res))


def _segment_spectra(records: torch.Tensor, *, window, hop, taper, detrend):
    """Complex half-spectra of every segment: ``(re, im)`` each ``[..., W, H]``.

    Same framing/detrend/taper conventions as :func:`_segment_mags`; DC is
    NOT zeroed here (the cross-spectral estimators handle bin 0).
    """
    segs, lead = _segment_front_end(records, window=window, hop=hop, taper=taper,
                                    detrend=detrend)
    re, im = fft_ops.fft_matmul_real(segs, half=True)
    h = re.shape[-1]
    return re.reshape(lead + (h,)), im.reshape(lead + (h,))


def _cross_moments(x, y, window, hop, taper, detrend, dtype, device, want_autos=True):
    """Shared core of :func:`cross_psd` and :func:`coherence_with_phase`.

    Validates, stacks the pair into one segment-spectra pass, and returns
    the Welch-averaged second moments ``(pxx, pyy, pr, pi, n_fft, device)``
    with the cross terms in scipy's ``conj(X) * Y`` sign convention.
    ``want_autos=False`` skips the auto-spectra (None in their slots).
    """
    x = placed(x, device, dtype)
    y = placed(y, device or x.device, dtype)
    if x.shape != y.shape:
        raise ValueError(f"x and y shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    hop = max(window // 2, 1) if hop is None else hop
    _check(taper, detrend)
    n_fft = fft_ops.next_pow2(window)
    re, im = _segment_spectra(torch.stack([x, y]), window=window, hop=hop, taper=taper,
                              detrend=detrend)
    (xr, yr), (xi, yi) = re, im
    pxx = _segment_mean(xr * xr + xi * xi) if want_autos else None
    pyy = _segment_mean(yr * yr + yi * yi) if want_autos else None
    pr = _segment_mean(xr * yr + xi * yi)
    pi = _segment_mean(xr * yi - xi * yr)
    return pxx, pyy, pr, pi, n_fft, x.device


def cross_psd(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
):
    """One-sided cross power spectral density ``(freqs, pxy)``.

    Welch-averaged ``E[conj(X(f)) * Y(f)]`` (scipy's sign convention:
    positive phase = ``y`` leads ``x``) with :func:`welch_psd`'s segmenting,
    window and scaling.  ``x``/``y`` are ``[..., T]`` records of one shape.
    ``pxy`` is a host numpy complex array with the DC bin zeroed, as the
    JAX package returns it; ``freqs`` a tensor on the records' device.
    """
    _, _, pr, pi, n_fft, dev = _cross_moments(x, y, window, hop, taper, detrend, dtype,
                                              device, want_autos=False)
    scale = _density_scale(fs, window, taper, dtype, dev)
    pxy = (pr * scale).cpu().numpy() + 1j * (pi * scale).cpu().numpy()
    pxy[..., 0] = 0.0  # DC zeroed, matching welch_psd
    return _bin_freqs(fs, n_fft, dtype, dev), pxy


def coherence(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
):
    """Magnitude-squared coherence ``(freqs, cxy)`` in [0, 1].

    ``|Pxy|^2 / (Pxx * Pyy)`` with Welch averaging (``scipy.signal.coherence``):
    ~1 where the two channels see the same linearly related signal, ~0
    where they are independent.  Needs several segments (one segment's
    coherence is identically 1).
    """
    freqs, cxy, _ = coherence_with_phase(x, y, fs, window, hop, taper=taper,
                                         detrend=detrend, dtype=dtype, device=device)
    return freqs, cxy


def coherence_with_phase(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
):
    """Coherence plus cross-spectral phase from one segment-spectra pass.

    ``(freqs, cxy, phase_deg)``: phase is scale-invariant, so the unscaled
    cross moments carry it (scipy's ``conj(X)*Y`` sign: positive = ``y``
    leads ``x``).  A channel with no power gives coherence 0.
    """
    pxx, pyy, pr, pi, n_fft, dev = _cross_moments(x, y, window, hop, taper, detrend,
                                                  dtype, device)
    denom = pxx * pyy
    pos = denom > 0
    cxy = torch.where(pos, (pr * pr + pi * pi) / torch.where(pos, denom, 1.0), 0.0)
    cxy[..., 0] = 0.0
    phase_deg = torch.rad2deg(torch.atan2(pi, pr))
    return _bin_freqs(fs, n_fft, dtype, dev), cxy, phase_deg


def analyze_epochs_pipelined(
    epochs: Iterable,
    fs,
    *,
    depth: int = 4,
    mode: str = "flexible",
    n_fft: int | None = None,
    analyze=analyze_epoch,
    device: torch.device | str | None = None,
    **kwargs,
) -> Iterator[EpochResult]:
    """Analyze a stream of epochs with up to ``depth`` dispatches in flight.

    The dynamic budget's exactness check normally reads back one scalar per
    epoch before the next epoch can be queued.  Here each epoch is queued at
    once with the sticky budget (an int budget: no readback), and the check
    runs when its result is yielded, re-running only an epoch that
    overflowed, as the sequential dynamic loop would.  Results come in
    input order with the decisions of :func:`analyze_epoch` per epoch.

    The sticky per-``(n_fft, mode)`` budget tables are ``analyze_epoch``'s;
    an epoch in flight may use a budget up to ``depth`` epochs stale, which
    costs at most an extra re-run.

    Args:
      epochs: iterable of ``[..., L]`` sample arrays or tensors.  An array
        goes to ``device`` (default the card) through pinned memory,
        without waiting for the card.
      fs: sampling rate, shared by the stream (scalar or broadcastable).
      depth: max epochs in flight (1 = sequential but deferred).
      mode: ``"flexible"`` or ``"rigid"`` (``"adaptive"``'s fallback needs
        an immediate readback; use ``analyze_epoch``).
      n_fft: optional fixed FFT length; default per-epoch ``next_pow2(L)``.
      analyze: the epoch function (default :func:`analyze_epoch`).
      **kwargs: forwarded to ``analyze`` (backend, k, refine, lowlat, dtype,
        ...); ``max_candidates`` is managed here and rejected.
    """
    # Validate eagerly: a plain function returning a generator, so a
    # misconfiguration fails at the call, not at the first next().
    if mode not in ("flexible", "rigid"):
        raise ValueError(
            f"pipelined analysis supports 'flexible' or 'rigid', got {mode!r}"
        )
    if "max_candidates" in kwargs:
        raise ValueError(
            "analyze_epochs_pipelined manages the candidate budget; pin one "
            "via analyze_epoch instead"
        )
    if "lengths" in kwargs:
        raise ValueError(
            "a stream-wide lengths array would misapply to every epoch; use "
            "analyze_records for ragged records"
        )
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dtype = kwargs.get("dtype", torch.float32)

    def dispatch(samples):
        samples = placed(samples, device, dtype)
        nf = n_fft if n_fft is not None else fft_ops.next_pow2(samples.shape[-1])
        h = max(nf // 2, 1)
        key = (nf, mode)
        budget = _budget.FLOOR if mode == "rigid" else min(_budget.sticky(key), h)  # rigid: unused
        res = analyze(samples, fs, n_fft=nf, mode=mode, max_candidates=budget, **kwargs)
        return samples, nf, h, key, budget, res

    def finalize(item) -> EpochResult:
        samples, nf, h, key, budget, res = item
        if mode == "rigid" or res.n_candidates.numel() == 0:
            return res
        # Exactness: every window's walk either completed within the budget
        # prefix or saw all its candidates (n_required <= budget).
        n_req = int(res.n_required.max())
        while n_req > budget and budget < h:
            budget = _budget.grow(key, n_req, h)
            res = analyze(samples, fs, n_fft=nf, mode=mode, max_candidates=budget, **kwargs)
            n_req = int(res.n_required.max())
        # The tier table and the stats stay as they were: no split runs here.
        _budget.settle(key, n_req, budget, h)
        return res

    def generate():
        pending: deque = deque()
        for samples in epochs:
            if len(pending) >= depth:
                yield finalize(pending.popleft())
            pending.append(dispatch(samples))
        while pending:
            yield finalize(pending.popleft())

    return generate()
