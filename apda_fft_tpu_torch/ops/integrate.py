"""Frequency-domain integration: acceleration -> velocity / displacement.

Counterpart of ``apda_fft_tpu/ops/integrate.py``.  Omega arithmetic in the
frequency domain, ``V(w) = A(w) / (iw)`` and ``D(w) = -A(w) / w^2``, behind
a Tukey edge taper and a raised-cosine high-pass transition band: one
``rfft`` -> scale -> ``irfft`` per record, batched.  The ISO 10816/20816
vibration severity (band-limited velocity RMS) comes from the velocity
spectrum by Parseval, without an inverse transform.

Units are the input's: acceleration in g integrates to g*s; multiply by
``G_TO_MMS2`` for mm/s.  Every entry point runs a tensor where it lies and
an array or list on the card unless ``device="cpu"`` is given (without a
card an array raises ``RuntimeError``); results are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import _from_host, _placed
from apda_fft_tpu_torch.ops.stats import div_exact

G_TO_MMS2 = 9806.65  # 1 g in mm/s^2: converts g*s velocities to ISO mm/s


def _tukey(n: int, alpha: float) -> np.ndarray:
    """Tukey (tapered-cosine) window, float64, flat over ``1 - alpha``."""
    t = np.arange(n) / (n - 1)
    w = np.ones(n)
    lo = t < alpha / 2
    w[lo] = 0.5 * (1.0 + np.cos(2.0 * np.pi / alpha * (t[lo] - alpha / 2)))
    hi = t >= 1.0 - alpha / 2
    w[hi] = 0.5 * (1.0 + np.cos(2.0 * np.pi / alpha * (t[hi] - 1.0 + alpha / 2)))
    return w


def _float_records(x, device) -> torch.Tensor:
    """``x`` placed as the entry points place it, float32 unless it is a
    float32 or float64 already."""
    x = _placed(x, device)
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    return x


def _rfft_freqs(n: int, fs: float, device) -> torch.Tensor:
    """``rfftfreq(n, 1/fs)`` computed in float64 as the JAX package computes
    it under x64 (``k / ((1/fs) * n)``), then cast to float32."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return _from_host(k / ((1.0 / fs) * n), device, torch.float32)


def _mean_centred(x: torch.Tensor) -> torch.Tensor:
    return x - div_exact(x.sum(dim=-1, keepdim=True), float(x.shape[-1]))


def _integrate_impl(x: torch.Tensor, win: torch.Tensor, fs: float, f_hp: float,
                    transition: float, *, order: int) -> torch.Tensor:
    n = x.shape[-1]
    spec = torch.fft.rfft(_mean_centred(x) * win)
    freqs = _rfft_freqs(n, fs, x.device)
    w = 2.0 * np.pi * freqs
    if transition > 0:
        # Raised cosine from f_hp to (1 + transition) * f_hp; the denominator
        # is formed in float64 and rounded once, as in the JAX package.
        ramp = torch.clamp(div_exact(freqs - f_hp, max(f_hp * transition, 1e-30)), 0.0, 1.0)
        gate = torch.where(freqs < f_hp, 0.0, 0.5 - 0.5 * torch.cos(np.pi * ramp))
    else:
        gate = (freqs >= f_hp).to(torch.float32)
    wsafe = torch.where(w > 0, w, 1.0)
    scale = gate * wsafe ** (-float(order))
    rot = (-1j) ** order  # 1/(iw) = -i/w
    mult = torch.complex(rot.real * scale, rot.imag * scale)
    spec = spec * mult
    # An inverse real FFT reads only the real part of the DC and (even n)
    # Nyquist bins, as numpy's and XLA's do; cuFFT's C2R lets their
    # imaginary parts leak into every sample, and an odd order makes the
    # Nyquist bin imaginary.
    spec.imag[..., [0, n // 2] if n % 2 == 0 else [0]] = 0.0
    return torch.fft.irfft(spec, n=n).to(x.dtype)


def integrate_acceleration(
    x, fs, *, order: int = 1, f_highpass=None, transition: float = 1.0,
    edge_taper: float = 0.3, device: torch.device | str | None = None,
) -> torch.Tensor:
    """Integrate acceleration record(s) ``x`` (``[..., T]``) ``order`` times.

    Args:
      x: time records, last axis is time (input units, e.g. g).
      fs: sampling rate (Hz).
      order: 1 -> velocity, 2 -> displacement.
      f_highpass: frequency below which content is discarded (Hz).
        Default ``8 * fs / T`` (eight analysis-bin widths).  Content is zero
        below ``f_highpass`` and fully passed above ``(1 + transition) *
        f_highpass``; treat ~``2.5 * f_highpass`` as the accurate passband
        edge.
      transition: width of the raised-cosine high-pass roll-off as a
        fraction of ``f_highpass`` (default 1.0 = one octave; 0 = hard cut).
      edge_taper: Tukey-window alpha applied before the transform (0
        disables; default 0.3).  Read results from the flat middle.
      device: where an array runs (default the card).

    Returns:
      Integrated record(s), same shape, units ``input * s^order``, a tensor
      on the records' device.
    """
    x = _float_records(x, device)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("integration needs at least 8 samples")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 (velocity) or 2 (displacement), got {order}")
    if not 0.0 <= edge_taper <= 1.0:
        raise ValueError(f"edge_taper must be in [0, 1], got {edge_taper}")
    if transition < 0.0:
        raise ValueError(f"transition must be >= 0, got {transition}")
    fs = float(fs)
    f_hp = float(f_highpass) if f_highpass is not None else 8.0 * fs / n
    win = _from_host(_tukey(n, edge_taper) if edge_taper > 0 else np.ones(n), x.device,
                     x.dtype)
    return _integrate_impl(x, win, fs, f_hp, float(transition), order=order)


def velocity(x, fs, *, f_highpass=None, transition: float = 1.0, edge_taper: float = 0.3,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Velocity from acceleration (``order=1``); see ``integrate_acceleration``."""
    return integrate_acceleration(x, fs, order=1, f_highpass=f_highpass,
                                  transition=transition, edge_taper=edge_taper, device=device)


def displacement(x, fs, *, f_highpass=None, transition: float = 1.0,
                 edge_taper: float = 0.3,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Displacement from acceleration (``order=2``); see ``integrate_acceleration``."""
    return integrate_acceleration(x, fs, order=2, f_highpass=f_highpass,
                                  transition=transition, edge_taper=edge_taper, device=device)


def _severity_impl(x: torch.Tensor, fs: float, f_lo: float, f_hi: float) -> torch.Tensor:
    n = x.shape[-1]
    spec = torch.fft.rfft(_mean_centred(x))
    freqs = _rfft_freqs(n, fs, x.device)
    w = 2.0 * np.pi * freqs
    band = (freqs >= f_lo) & (freqs <= f_hi) & (w > 0)
    vmag2 = torch.where(band, spec.abs() ** 2 / torch.where(w > 0, w, 1.0) ** 2, 0.0)
    # Parseval for the one-sided rfft of a real series: interior bins carry
    # their conjugate twins' power; DC is cut by the band, Nyquist (even n)
    # is its own twin.
    weight = torch.full((n // 2 + 1,), 2.0, dtype=vmag2.dtype, device=x.device)
    weight[0] = 1.0
    if n % 2 == 0:
        weight[-1] = 1.0
    return torch.sqrt(div_exact((vmag2 * weight).sum(dim=-1), float(n * n)))


def velocity_rms(x, fs, band=(10.0, 1000.0), *,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Band-limited velocity RMS of acceleration record(s) - the ISO
    10816/20816 vibration-severity quantity, a batch-shaped tensor.

    Computed from the velocity spectrum via Parseval (no inverse transform,
    no edge taper).  ``band`` is ``(f_lo, f_hi)`` in Hz; ``f_hi`` is clamped
    to Nyquist.  Units: ``input * s`` RMS (g in -> g*s; x ``G_TO_MMS2`` for
    the ISO mm/s).
    """
    x = _float_records(x, device)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("severity needs at least 8 samples")
    fs = float(fs)
    f_lo, f_hi = float(band[0]), min(float(band[1]), fs / 2.0)
    if not 0.0 < f_lo < f_hi:
        raise ValueError(f"need 0 < f_lo < f_hi <= fs/2, got {band}")
    return _severity_impl(x, fs, f_lo, f_hi)
