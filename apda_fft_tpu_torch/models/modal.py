"""Operational modal analysis by Frequency-Domain Decomposition (FDD).

Counterpart of ``apda_fft_tpu/models/modal.py``.  Over ``[S, T]`` records of
``S`` simultaneously sampled sensors:

1. the cross-spectral density matrix ``G(f) [S, S]`` (Welch-averaged, the
   conventions of :func:`~apda_fft_tpu_torch.models.streaming.cross_psd`):
   every channel's segment spectra in one four-step pass, then one batched
   product over the segment axis;
2. the first two singular triplets of ``G(f)`` at every frequency line by a
   batched power iteration with one Hotelling deflation, in all-real
   arithmetic (``G`` is Hermitian PSD, so its singular triplets are its
   eigen triplets): 60 steps from the JAX package's start vector, each a
   pair of batched matrix products;
3. the flexible prominence detector on ``sqrt(s1(f))``: on the card that is
   the select+scan kernel (``csrc/prominence_select_scan.cu``) at the
   static budget ``default_max_candidates(n_fft)``, so the call needs no
   readback until its result comes to the host, in one copy per dtype;
4. mode shapes from the first singular vectors at the accepted peaks, and
   on the host the enhanced-FDD damping (:func:`_efdd_zeta`) and the
   narrowband-kurtosis harmonic indicator (:func:`harmonic_indicator`).

Every product runs in IEEE float32 (``ops.fft.ieee_fp32_matmul``).  The
mode trackers and :func:`modal_assurance` are host numpy, re-stated from the
JAX package.  Entry points run a tensor where it lies and an array or list
on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from apda_fft_tpu_torch.models import pipeline as _pipeline
from apda_fft_tpu_torch.models.batching import _host_copies
from apda_fft_tpu_torch.models.streaming import (
    DETRENDS,
    _bin_freqs,
    _segment_spectra,
    _taper_power_sum,
)
from apda_fft_tpu_torch.ops import fft as fft_ops
from apda_fft_tpu_torch.ops.fft import ieee_fp32_matmul
from apda_fft_tpu_torch.ops.stats import div_exact

#: Power-iteration steps for the per-frequency dominant eigenpair: the
#: iterate converges as (s2/s1)**t, so at 60 steps a 0.9 ratio is resolved
#: to ~2e-3.
_POWER_ITERS = 60


class FDDResult(NamedTuple):
    """Modes identified by FDD, plus the singular-value spectra behind them.

    Host numpy, as the JAX package returns it.  ``k`` mode slots (``count``
    valid, unused slots ``idx = -1`` / zeros), ``S`` sensors, ``H`` frequency
    bins.  Mode shapes are unit-norm complex vectors phase-rotated so the
    largest-magnitude component is real positive.
    """

    count: np.ndarray  # [] int32 - number of valid mode slots
    idx: np.ndarray  # [k] int32 bin index, -1 = empty
    freq: np.ndarray  # [k] Hz (detector 4-dp rounding convention)
    damping: np.ndarray  # [k] percent of critical, from the s1 bell's half-power width
    sv_ratio: np.ndarray  # [k] s2/s1 at the peak - mode-separation measure
    shape_re: np.ndarray  # [k, S] mode shape, real part
    shape_im: np.ndarray  # [k, S] mode shape, imaginary part
    freqs: np.ndarray  # [H] bin frequencies
    sv1: np.ndarray  # [H] first singular value of G(f) (density units)
    sv2: np.ndarray  # [H] second singular value
    damping_efdd: np.ndarray  # [k] percent, enhanced-FDD estimate (NaN when off/untrusted)
    kurtosis: np.ndarray = None  # [k] narrowband kurtosis (NaN when harmonics=False)

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def shapes(self) -> np.ndarray:
        """Complex [k, S] mode-shape matrix."""
        return self.shape_re + 1j * self.shape_im

    def harmonic_mask(self, kurtosis_max: float = 2.2) -> np.ndarray:
        """Boolean [k]: True where the mode looks like a forced harmonic
        (needs ``fdd(..., harmonics=True)``; NaN slots are never flagged)."""
        if self.kurtosis is None:
            return np.zeros(self.idx.shape[-1], bool)
        with np.errstate(invalid="ignore"):
            return np.asarray(self.kurtosis < kurtosis_max) & np.isfinite(self.kurtosis)


def _check_records(records: torch.Tensor, hop: int | None) -> None:
    if records.dim() != 2:
        raise ValueError(f"records must be [S, T], got shape {tuple(records.shape)}")
    if hop is not None and hop < 1:
        raise ValueError(f"hop must be >= 1 (or None for 50% overlap), got {hop}")


def csd_matrix(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
):
    """One-sided cross-spectral density matrix ``(freqs, gr, gi)``, tensors.

    ``records`` is ``[S, T]``; ``gr + 1j*gi`` is ``[H, S, S]`` with
    ``G[f, a, b] = E[conj(X_a(f)) * X_b(f)]`` in density units, Hermitian,
    DC zeroed; the diagonal equals ``welch_psd``.
    """
    records = _pipeline._placed(records, device, dtype)
    _check_records(records, hop)
    if records.shape[0] < 1:
        raise ValueError("need at least one sensor channel")
    hop = max(window // 2, 1) if hop is None else hop
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    n_fft = fft_ops.next_pow2(window)
    wsum2 = float(window) if taper == "none" else _taper_power_sum(taper, window)
    scale = 2.0 / (float(fs) * wsum2)
    gr, gi = _csd_impl(records, scale, window=window, hop=hop, taper=taper, detrend=detrend)
    return _bin_freqs(fs, n_fft, dtype, records.device), gr, gi


def _csd_impl(records: torch.Tensor, scale: float, *, window, hop, taper, detrend):
    re, im = _segment_spectra(records, window=window, hop=hop, taper=taper,
                              detrend=detrend)  # [S, W, H]
    s = div_exact(torch.full((), scale, dtype=re.dtype, device=re.device), float(re.shape[-2]))
    # G[h, a, b] = scale * mean_w conj(X_a) X_b: Re = xr_a xr_b + xi_a xi_b,
    # Im = xr_a xi_b - xi_a xr_b, every product from one [H, 2S, 2S] Gram.
    z = torch.cat([re, im]).permute(2, 0, 1)  # [H, 2S, W]
    with ieee_fp32_matmul():
        p = torch.matmul(z, z.transpose(-1, -2))
    n = re.shape[0]
    gr = (p[:, :n, :n] + p[:, n:, n:]) * s
    gi = (p[:, :n, n:] - p[:, n:, :n]) * s
    # DC zeroed (library-wide convention; the detrend already removed it).
    gr[0] = 0.0
    gi[0] = 0.0
    return gr, gi


def _matvec(gr: torch.Tensor, gi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched Hermitian matvec ``G v`` with ``v`` as ``[..., S, 2]`` (re, im)."""
    a = torch.matmul(gr, v)
    b = torch.matmul(gi, v)
    # Re = gr vr - gi vi, Im = gr vi + gi vr.
    return torch.stack([a[..., 0] - b[..., 1], a[..., 1] + b[..., 0]], dim=-1)


def _normalized(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]).sum(dim=-1))
    pos = n > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, n, 1.0), 0.0)
    return v * inv[..., None, None]


def _power_top(gr: torch.Tensor, gi: torch.Tensor, iters: int):
    """Dominant eigenpair ``(lam [...], v [..., S, 2])`` of batched Hermitian
    PSD ``G`` by power iteration, ``v`` unit-norm.  The start vector is ``G
    u`` with the JAX package's slightly graded real ``u``."""
    s = gr.shape[-1]
    u = 1.0 + div_exact(torch.arange(s, dtype=gr.dtype, device=gr.device), 3.0 + s)
    v = torch.stack([u, torch.zeros_like(u)], dim=-1).expand(*gr.shape[:-1], 2)
    with ieee_fp32_matmul():
        v = _normalized(_matvec(gr, gi, v))
        for _ in range(iters):
            v = _normalized(_matvec(gr, gi, v))
        # Rayleigh quotient (real for Hermitian G): lam = v^H G v.
        y = _matvec(gr, gi, v)
    lam = (v[..., 0] * y[..., 0] + v[..., 1] * y[..., 1]).sum(dim=-1)
    return lam, v


def _phase_fix(vr: torch.Tensor, vi: torch.Tensor):
    """Rotate each vector so its largest-|.| component is real positive
    (the first such component on ties)."""
    j = torch.argmax(vr * vr + vi * vi, dim=-1, keepdim=True)
    pr = torch.gather(vr, -1, j)
    pi = torch.gather(vi, -1, j)
    m = torch.sqrt(pr * pr + pi * pi)
    pos = m > 0
    cr = torch.where(pos, pr / torch.where(pos, m, 1.0), 1.0)
    ci = torch.where(pos, pi / torch.where(pos, m, 1.0), 0.0)
    # v * conj(p/|p|)
    return vr * cr + vi * ci, vi * cr - vr * ci


def sv_spectra(gr: torch.Tensor, gi: torch.Tensor, iters: int = _POWER_ITERS):
    """First two singular triplets of batched Hermitian PSD matrices.

    ``(s1, s2, vr, vi)`` tensors with the leading batch shape (one entry per
    frequency line): ``s1/s2`` the top two singular values and ``v`` the unit
    first singular vector, phase-fixed.  ``s2`` comes from one Hotelling
    deflation ``G - s1 v v^H`` followed by a second power iteration.
    """
    s1, v = _power_top(gr, gi, iters)
    vr, vi = v[..., 0], v[..., 1]
    # Deflate: G' = G - s1 v v^H  (Re: vr vr^T + vi vi^T; Im: vi vr^T - vr vi^T).
    l1 = s1[..., None, None]
    dr = gr - l1 * (vr[..., :, None] * vr[..., None, :] + vi[..., :, None] * vi[..., None, :])
    di = gi - l1 * (vi[..., :, None] * vr[..., None, :] - vr[..., :, None] * vi[..., None, :])
    s2, _ = _power_top(dr, di, iters)
    # Deflation roundoff can leave s2 a hair negative or above s1 on rank-1
    # inputs; clamp into the valid band.
    s2 = torch.minimum(torch.clamp(s2, min=0.0), s1)
    vr, vi = _phase_fix(vr, vi)
    return s1, s2, vr, vi


def fdd_segments(t: int, window: int, hop: int | None = None) -> int:
    """Number of Welch segments :func:`fdd`/:func:`csd_matrix` will frame."""
    hop = max(window // 2, 1) if hop is None else hop
    if t < window:
        return 0
    return (t - window) // hop + 1


def _band_kurtosis_impl(records: torch.Tensor, k_idx: torch.Tensor, n_bins: torch.Tensor, *,
                        window: int):
    """Narrowband kurtosis per (mode, sensor) and band energy, ``[M, S]`` each.

    Non-overlapping boxcar segments are band-masked in the frequency domain
    and synthesized back with two ``[H, window]`` products; the kurtosis is
    taken over every segment sample.
    """
    re, im = _segment_spectra(records, window=window, hop=window, taper="none",
                              detrend="mean")  # [S, W, H]
    h = re.shape[-1]
    n_fft = 2 * h
    k = torch.arange(h, dtype=torch.int32, device=re.device)
    # Band mask per mode: |k - k_m| <= n_bins_m, DC excluded. [M, H]
    band = (((k[None, :] - k_idx[:, None]).abs() <= n_bins[:, None])
            & (k[None, :] > 0)).to(re.dtype)
    mr = re[None] * band[:, None, None, :]  # [M, S, W, H]
    mi = im[None] * band[:, None, None, :]
    # Real synthesis over the un-padded sample range: x[t] = (2/N) *
    # sum_k (re cos(2 pi k t / N) - im sin(.)).  Nyquist is not in the half
    # spectrum and DC is masked, so the factor 2 is exact.
    t = torch.arange(window, dtype=re.dtype, device=re.device)
    ang = (2.0 * math.pi / n_fft) * k.to(re.dtype)[:, None] * t[None, :]
    with ieee_fp32_matmul():
        x = (torch.matmul(mr, torch.cos(ang)) - torch.matmul(mi, torch.sin(ang))) * (2.0 / n_fft)
    count = float(x.shape[-2] * x.shape[-1])
    xm = x - div_exact(x.sum(dim=(-2, -1), keepdim=True), count)
    m2 = div_exact((xm * xm).sum(dim=(-2, -1)), count)  # [M, S]
    m4 = div_exact((xm ** 4).sum(dim=(-2, -1)), count)
    kur = m4 / torch.clamp(m2 * m2, min=float(np.finfo(np.float32).tiny))
    return kur, m2


def harmonic_indicator(
    records,
    fs,
    freqs_hz,
    *,
    window: int = 1024,
    rel_bandwidth: float = 0.02,
    min_bins: int = 3,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Narrowband-kurtosis harmonic indicator per candidate frequency.

    ``records [S, T]`` (or ``[T]``) is band-filtered around each frequency
    in ``freqs_hz`` (half-bandwidth ``max(min_bins, rel_bandwidth * f / df)``
    bins), and the kurtosis of each sensor's filtered response is averaged
    across sensors weighted by band energy.  Returns ``[len(freqs_hz)]``
    host float64; NaN where the frequency is out of band or carries no
    energy.  Near 1.5 flags a deterministic harmonic, near 3.0 a
    stochastically excited structural mode.
    """
    records = _pipeline._placed(records, device, dtype)
    if records.dim() == 1:
        records = records[None, :]
    if records.dim() != 2:
        raise ValueError(f"records must be [S, T] or [T], got {tuple(records.shape)}")
    if window < 8:
        raise ValueError(f"window must be >= 8, got {window}")
    if records.shape[-1] < window:
        raise ValueError(
            f"record too short for kurtosis estimation: T={records.shape[-1]}"
            f" < window={window}"
        )
    if not 0.0 < rel_bandwidth < 0.5:
        raise ValueError(f"rel_bandwidth must be in (0, 0.5), got {rel_bandwidth}")
    fs = float(fs)
    freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    n_fft = fft_ops.next_pow2(window)
    h = n_fft // 2
    df = fs / n_fft
    f_safe = np.where(np.isfinite(freqs_hz), freqs_hz, 0.0)
    k_idx = np.rint(f_safe / df).astype(np.int32)
    n_bins = np.maximum(min_bins, np.rint(rel_bandwidth * f_safe / df)).astype(np.int32)
    valid = (k_idx > 0) & (k_idx < h) & np.isfinite(freqs_hz)
    dev = records.device
    kur, energy = _band_kurtosis_impl(
        records,
        _pipeline._from_host(np.where(valid, k_idx, 1), dev),
        _pipeline._from_host(np.where(valid, n_bins, 0), dev),
        window=window,
    )
    kur, w = torch.stack([kur, energy]).cpu().numpy().astype(np.float64)  # [M, S] each
    tot = w.sum(axis=-1)
    out = np.full(len(freqs_hz), np.nan)
    ok = valid & (tot > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = (kur * w).sum(axis=-1) / np.where(tot > 0, tot, 1.0)
    out[ok] = avg[ok]
    return out


def _efdd_zeta(
    sv1: np.ndarray,
    vr: np.ndarray,
    vi: np.ndarray,
    i0: int,
    fs: float,
    window: int,
    mac_min: float = 0.8,
) -> float:
    """Enhanced-FDD damping (percent) for the mode peaking at bin ``i0``.

    Around the peak, the bins whose first singular vector still matches the
    peak's shape (MAC >= ``mac_min``, and power >= 2% of the peak's) form
    the mode's SDOF bell; its inverse transform is the mode's free-decay
    autocorrelation, whose envelope is fitted by log decrement after the
    Welch segment's Bartlett factor ``log(1 - t/T_seg)`` is subtracted.
    NaN when the bell is narrower than 3 bins, the fit spans fewer than 2
    cycles, or the decay estimate is not positive.
    """
    h = sv1.shape[0]
    phi_r, phi_i = vr[i0], vi[i0]
    dot_r = vr @ phi_r + vi @ phi_i
    dot_i = vr @ phi_i - vi @ phi_r
    mac = dot_r * dot_r + dot_i * dot_i  # unit vectors: |<phi(f), phi0>|^2
    in_bell = (mac >= mac_min) & (sv1 >= 0.02 * sv1[i0])
    lo = i0
    while lo > 0 and in_bell[lo - 1]:
        lo -= 1
    hi = i0
    while hi < h - 1 and in_bell[hi + 1]:
        hi += 1
    if hi - lo + 1 < 3:
        return float("nan")

    bell = np.zeros(h + 1, np.float64)
    bell[lo : hi + 1] = sv1[lo : hi + 1]
    r = np.fft.irfft(bell, n=2 * h)  # modal autocorrelation, dt = 1/fs
    n = r.shape[0]

    # Analytic envelope (Hilbert via the half-spectrum trick).
    spec = np.fft.fft(r)
    spec[1 : n // 2] *= 2.0
    spec[n // 2 + 1 :] = 0.0
    env = np.abs(np.fft.ifft(spec))

    # Fit from the t=0 peak down to the 5% floor, only over the first half
    # (the irfft correlation is circular).
    t = np.arange(n) / fs
    t_seg = window / fs
    fit = (env > 0.05 * env[0]) & (np.arange(n) < n // 2) & (t < 0.95 * t_seg)
    if fit.sum() < 4:
        return float("nan")
    f0 = i0 * fs / (2 * h)
    if f0 <= 0 or (fit.sum() / fs) * f0 < 2.0:  # < 2 cycles above floor
        return float("nan")
    tw = t[fit]
    yw = np.log(np.maximum(env[fit], 1e-300)) - np.log1p(-tw / t_seg)
    slope = np.polyfit(tw, yw, 1)[0]
    zeta = -slope / (2.0 * np.pi * f0)
    if not np.isfinite(zeta) or zeta <= 0:
        return float("nan")
    return 100.0 * zeta


def fdd(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    k: int | None = None,
    max_candidates: int | None = None,
    selection: str = "auto",
    iters: int = _POWER_ITERS,
    efdd: bool = False,
    harmonics: bool = False,
    dtype: torch.dtype = torch.float32,
    mesh=None,
    mesh_axis: str | None = None,
    device: torch.device | str | None = None,
) -> FDDResult:
    """Frequency-Domain Decomposition over ``[S, T]`` multi-sensor records.

    CSD matrix -> per-frequency top-2 singular triplets -> the flexible
    prominence detector on ``sqrt(s1(f))`` at the static budget
    ``max_candidates`` (default ``default_max_candidates(n_fft)``) -> mode
    shapes from the first singular vectors at the accepted peaks.  ``k``
    defaults to the flexible detector's 4 slots.  Needs at least 2 segments.

    ``efdd=True`` fills ``damping_efdd`` with the enhanced-FDD estimate;
    ``harmonics=True`` fills ``kurtosis`` with :func:`harmonic_indicator`.
    ``selection`` takes only ``"auto"``, the port's one order-exact
    selection.  A sharded run (``mesh=``) is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError("sharded FDD (mesh=) is not ported yet")
    if selection != "auto":
        raise ValueError(f"unknown selection {selection!r}; the port has only 'auto'")
    records = _pipeline._placed(records, device, dtype)
    _check_records(records, hop)
    if fdd_segments(records.shape[-1], window, hop) < 2:
        raise ValueError(f"need >= 2 segments: T={records.shape[-1]} with window={window}")
    if k is None:
        k = _pipeline.default_k("flexible")
    n_fft = fft_ops.next_pow2(window)
    if max_candidates is None:
        max_candidates = _pipeline.default_max_candidates(n_fft)

    freqs, gr, gi = csd_matrix(records, fs, window, hop, taper=taper, detrend=detrend,
                               dtype=dtype)
    s1, s2, vr, vi = sv_spectra(gr, gi, iters=iters)
    # Equivalent-magnitude spectrum: sqrt of the power-like s1, so the
    # detector's -3 dB width (and its damping) reads on a magnitude scale.
    mags = torch.sqrt(torch.clamp(s1, min=0.0))[None, :]
    fs_b = _pipeline._fs_tensor(fs, mags.dtype, mags.device).reshape(1)
    det = _pipeline._detect_from_mags(mags, fs_b, n_fft=n_fft, mode="flexible", k=k,
                                      max_candidates=max_candidates, refine=False)
    host = [t.numpy() for t in _host_copies([*det, freqs, s1, s2, vr, vi])]
    det_h = det._make(host[: len(det)])
    freqs_h, s1_h, s2_h, vr_h, vi_h = host[len(det):]

    count = int(det_h.count[0])
    idx = det_h.idx[0]
    valid = idx >= 0
    safe = np.where(valid, idx, 0)
    ratio = np.where(
        valid & (s1_h[safe] > 0), s2_h[safe] / np.where(s1_h[safe] > 0, s1_h[safe], 1.0), 0.0
    ).astype(s1_h.dtype)
    shape_re = np.where(valid[:, None], vr_h[safe], 0.0).astype(s1_h.dtype)
    shape_im = np.where(valid[:, None], vi_h[safe], 0.0).astype(s1_h.dtype)
    zeta_e = np.full(idx.shape, np.nan, s1_h.dtype)
    if efdd:
        for slot in range(count):
            zeta_e[slot] = _efdd_zeta(s1_h.astype(np.float64), vr_h.astype(np.float64),
                                      vi_h.astype(np.float64), int(idx[slot]), float(fs),
                                      window)
    kurt = np.full(idx.shape, np.nan)
    if harmonics and count:
        kurt[:count] = harmonic_indicator(records, fs, det_h.freq[0][:count], window=window,
                                          dtype=dtype)
    return FDDResult(
        count=det_h.count[0],
        idx=idx,
        freq=det_h.freq[0],
        damping=det_h.damping[0],
        sv_ratio=ratio,
        shape_re=shape_re,
        shape_im=shape_im,
        freqs=freqs_h,
        sv1=s1_h,
        sv2=s2_h,
        damping_efdd=zeta_e,
        kurtosis=kurt,
    )


class ModeTrack:
    """One persistent structural mode over time (frequency + shape).

    ``ref_shape`` is the complex mode shape at track birth (the healthy
    baseline); every later observation records its MAC against it, so a
    sustained MAC drop - the shape-based damage indicator - is an output.
    """

    def __init__(self, track_id: int, t, freq: float, shape: np.ndarray, damping: float):
        self.track_id = track_id
        self.times = [t]
        self.freqs = [float(freq)]
        self.dampings = [float(damping)]
        self.ref_shape = np.asarray(shape, np.complex128)
        self.last_shape = self.ref_shape
        self.macs = [1.0]
        self.missed = 0
        self.observed = 1
        self.alerted = False  # one shape alert per track
        self.damping_alerted = False  # same policy, damping alert

    @property
    def last_freq(self) -> float:
        return self.freqs[-1]

    def sustained_mac(self, k: int = 3) -> float:
        """Median MAC of the last ``k`` observations vs the birth shape."""
        k = max(1, min(k, len(self.macs)))
        return float(np.median(self.macs[-k:]))

    def sustained_damping(self, k: int = 3) -> float:
        """Median damping (percent) of the last ``k`` observations."""
        k = max(1, min(k, len(self.dampings)))
        return float(np.median(self.dampings[-k:]))

    @property
    def birth_damping(self) -> float:
        """Damping (percent) at track birth - the healthy baseline."""
        return float(self.dampings[0])

    def damping_estimate(self, k: int | None = None) -> tuple[float, float, int]:
        """Aggregated damping over the last ``k`` observations:
        ``(mean_pct, sem_pct, n)``; NaN observations (rejected fits) are
        excluded, ``sem_pct`` is 0 when n < 2."""
        d = np.asarray(self.dampings, np.float64)
        d = d[np.isfinite(d) & (d > 0)]
        if k is not None:
            d = d[-max(1, k):]
        n = d.size
        if n == 0:
            return float("nan"), float("nan"), 0
        mean = float(d.mean())
        sem = float(d.std(ddof=1) / np.sqrt(n)) if n >= 2 else 0.0
        return mean, sem, n

    def damping_windows(self, k: int = 5):
        """Disjoint (baseline, recent) damping aggregates for trend tests,
        each ``(mean_pct, sem_pct, n)``; None with fewer than 2 valid
        observations."""
        d = np.asarray(self.dampings, np.float64)
        d = d[np.isfinite(d) & (d > 0)]
        if d.size < 2:
            return None
        nb = max(1, min(k, d.size // 2))
        nr = max(1, min(k, d.size - nb))

        def agg(x: np.ndarray):
            m = float(x.mean())
            s = float(x.std(ddof=1) / np.sqrt(x.size)) if x.size >= 2 else 0.0
            return m, s, int(x.size)

        return agg(d[:nb]), agg(d[-nr:])

    def observe(self, t, freq: float, shape: np.ndarray, damping: float,
                history_cap: int = 0) -> None:
        shape = np.asarray(shape, np.complex128)
        self.times.append(t)
        self.freqs.append(float(freq))
        self.dampings.append(float(damping))
        self.macs.append(float(modal_assurance(shape, self.ref_shape)[0, 0]))
        self.last_shape = shape
        self.missed = 0
        self.observed += 1
        if history_cap and len(self.freqs) > history_cap:
            # Trim the middle: keep the birth head and the recent tail.
            cut = slice(8, 9)
            del self.times[cut], self.freqs[cut], self.dampings[cut], self.macs[cut]

    def to_dict(self) -> dict:
        return {
            "track_id": self.track_id,
            "epochs": self.observed,
            "times": [float(t) for t in self.times],
            "freqs": [float(f) for f in self.freqs],
            "dampings": [float(d) for d in self.dampings],
            "macs": [float(m) for m in self.macs],
            "ref_shape": [[float(c.real), float(c.imag)] for c in self.ref_shape],
            "last_shape": [[float(c.real), float(c.imag)] for c in self.last_shape],
            "missed": self.missed,
            "alerted": self.alerted,
            "damping_alerted": self.damping_alerted,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModeTrack":
        ref = np.asarray([complex(re, im) for re, im in d["ref_shape"]])
        tr = cls(int(d["track_id"]), d["times"][0] if d.get("times") else 0,
                 d["freqs"][0], ref, d["dampings"][0])
        tr.times = list(d.get("times", [0.0] * len(d["freqs"])))
        tr.freqs = [float(f) for f in d["freqs"]]
        tr.dampings = [float(x) for x in d["dampings"]]
        tr.macs = [float(m) for m in d["macs"]]
        tr.last_shape = np.asarray([complex(re, im) for re, im in d["last_shape"]])
        tr.observed = int(d["epochs"])
        tr.missed = int(d.get("missed", 0))
        tr.alerted = bool(d.get("alerted", False))
        tr.damping_alerted = bool(d.get("damping_alerted", False))
        return tr

    def __len__(self) -> int:
        return len(self.freqs)


class ModalTracker:
    """Track FDD (or SSI) modes across epochs by frequency AND mode shape.

    Each epoch's modes are matched to persistent :class:`ModeTrack`\\ s: a
    pair is admissible iff the relative frequency distance is within
    ``rel_tol`` and the MAC against the track's birth shape is at least
    ``mac_min``; admissible pairs are taken greedily by the combined
    normalized distance, shape first (``1 - MAC`` weighted double).
    ``shape_alerts()`` lists tracks whose sustained MAC fell below
    ``mac_alert``.  Host numpy.
    """

    #: retired tracks kept for history (oldest dropped past this)
    ARCHIVE_KEEP = 64
    #: per-archived-track observation cap (birth head 8 + recent tail)
    ARCHIVE_OBS_KEEP = 64

    def __init__(self, rel_tol: float = 0.05, mac_min: float = 0.7,
                 mac_alert: float = 0.9, max_missed: int = 5,
                 history_cap: int = 2048):
        self.rel_tol = rel_tol
        self.mac_min = mac_min
        self.mac_alert = mac_alert
        self.max_missed = max_missed
        #: per-live-track observation cap (middle-trimmed past it; 0 = off)
        self.history_cap = history_cap
        self._tracks: list[ModeTrack] = []
        self._archive: list[ModeTrack] = []
        self._next_id = 0
        self._epoch = 0

    def update(self, res, t=None) -> list[ModeTrack]:
        """Match one epoch's modes; returns the tracks matched or born.

        Takes an :class:`FDDResult` or an
        :class:`~apda_fft_tpu_torch.models.ssi.SSIResult` (duck-typed on the
        ``modes`` list).
        """
        t = self._epoch if t is None else t
        self._epoch += 1
        if hasattr(res, "modes"):  # SSIResult
            freqs = [m.freq for m in res.modes]
            shapes = [m.shape for m in res.modes]
            damps = [m.damping for m in res.modes]
            n = len(freqs)
        else:  # FDDResult
            n = int(res.count)
            freqs = [float(res.freq[i]) for i in range(n)]
            shapes = [res.shapes()[i] for i in range(n)]
            damps = [float(res.damping[i]) for i in range(n)]

        live = []
        for tr in self._tracks:
            if tr.missed < self.max_missed:
                live.append(tr)
                continue
            # Retired tracks never grow again: trim their observations and
            # bound the archive (oldest out first).
            if len(tr.freqs) > self.ARCHIVE_OBS_KEEP:
                head, tail = 8, self.ARCHIVE_OBS_KEEP - 8
                cut = slice(head, len(tr.freqs) - tail)
                del tr.times[cut], tr.freqs[cut], tr.dampings[cut], tr.macs[cut]
            self._archive.append(tr)
        if len(self._archive) > self.ARCHIVE_KEEP:
            del self._archive[: len(self._archive) - self.ARCHIVE_KEEP]
        self._tracks = live

        # Admissible (track, mode) pairs, greedily by combined distance.
        cand: list[tuple[float, int, int]] = []
        for ti, tr in enumerate(live):
            for ni in range(n):
                df = abs(freqs[ni] - tr.last_freq)
                if tr.last_freq <= 0 or df > self.rel_tol * tr.last_freq:
                    continue
                mac = float(modal_assurance(shapes[ni], tr.ref_shape)[0, 0])
                if mac < self.mac_min:
                    continue
                score = df / (self.rel_tol * tr.last_freq) + 2.0 * (1.0 - mac)
                cand.append((score, ti, ni))
        cand.sort()
        used_t: set[int] = set()
        used_n: set[int] = set()
        out: list[ModeTrack] = []
        for _, ti, ni in cand:
            if ti in used_t or ni in used_n:
                continue
            used_t.add(ti)
            used_n.add(ni)
            live[ti].observe(t, freqs[ni], shapes[ni], damps[ni], history_cap=self.history_cap)
            out.append(live[ti])
        for ti, tr in enumerate(live):
            if ti not in used_t:
                tr.missed += 1
        for ni in range(n):
            if ni not in used_n:
                tr = ModeTrack(self._next_id, t, freqs[ni], shapes[ni], damps[ni])
                self._next_id += 1
                self._tracks.append(tr)
                out.append(tr)
        return out

    def tracks(self) -> list[ModeTrack]:
        return list(self._tracks) + list(self._archive)

    def shape_alerts(self, min_epochs: int = 3) -> list[ModeTrack]:
        """Tracks whose sustained MAC vs birth shape fell below ``mac_alert``."""
        return [
            tr for tr in self._tracks
            if tr.observed >= min_epochs and tr.sustained_mac() < self.mac_alert
        ]

    def to_dict(self) -> dict:
        """JSON-serializable state (the shape/damping baselines are the
        damage references a restart must keep)."""
        return {
            "rel_tol": self.rel_tol,
            "mac_min": self.mac_min,
            "mac_alert": self.mac_alert,
            "max_missed": self.max_missed,
            "history_cap": self.history_cap,
            "next_id": self._next_id,
            "epoch": self._epoch,
            "tracks": [tr.to_dict() for tr in self._tracks],
            "archive": [tr.to_dict() for tr in self._archive],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModalTracker":
        mt = cls(rel_tol=float(d["rel_tol"]), mac_min=float(d["mac_min"]),
                 mac_alert=float(d["mac_alert"]), max_missed=int(d["max_missed"]),
                 history_cap=int(d.get("history_cap", 2048)))
        mt._next_id = int(d["next_id"])
        mt._epoch = int(d["epoch"])
        mt._tracks = [ModeTrack.from_dict(x) for x in d.get("tracks", [])]
        mt._archive = [ModeTrack.from_dict(x) for x in d.get("archive", [])]
        return mt

    def damping_alerts(self, rel_increase: float = 0.5,
                       min_epochs: int = 5, sem_z: float = 2.0) -> list[ModeTrack]:
        """Tracks whose damping rose >= ``rel_increase`` AND whose rise is
        statistically resolved: disjoint baseline and recent window means
        (:meth:`ModeTrack.damping_windows`) with ``recent - base >
        sem_z*sqrt(sem_b^2 + sem_r^2)``.  A zero or invalid birth damping
        never alerts."""
        out = []
        for tr in self._tracks:
            if tr.observed < min_epochs or tr.birth_damping <= 0:
                continue
            w = tr.damping_windows()
            if w is None:
                continue
            (mb, sb, _), (mr, sr, _) = w
            if mr < (1.0 + rel_increase) * mb:
                continue
            if (mr - mb) <= sem_z * float(np.hypot(sb, sr)):
                continue
            out.append(tr)
        return out


def modal_assurance(a, b) -> np.ndarray:
    """Modal Assurance Criterion matrix between two shape sets.

    ``a`` is ``[ka, S]`` (or ``[S]``), ``b`` ``[kb, S]``; returns the
    ``[ka, kb]`` matrix ``|a_i^H b_j|^2 / (|a_i|^2 |b_j|^2)`` in [0, 1].
    """
    a = np.atleast_2d(np.asarray(a))
    b = np.atleast_2d(np.asarray(b))
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"sensor counts differ: {a.shape[-1]} vs {b.shape[-1]}")
    num = np.abs(a.conj() @ b.T) ** 2
    na = np.sum(np.abs(a) ** 2, axis=-1)
    nb = np.sum(np.abs(b) ** 2, axis=-1)
    den = np.outer(na, nb)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
