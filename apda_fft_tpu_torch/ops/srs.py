"""Shock Response Spectrum - damage-potential characterization of shocks.

Counterpart of ``apda_fft_tpu/ops/srs.py``.  A bank of single-degree-of-
freedom oscillators (log-spaced natural frequencies, common Q) is driven by
the measured base acceleration through the ISO 18431-4 ramp-invariant
(Smallwood) digital filter, and each oscillator's extreme response is kept.

The second-order recurrence runs as a first-order affine recurrence in the
*realified-diagonal (rotation) coordinates* of the JAX package: with
``z = P^-1 [y[t], y[t-1]]`` and ``P = [[alpha, -beta], [1, 0]]``::

    z[t] = M z[t-1] + [0, -u[t]/beta],   M = [[alpha, -beta], [beta, alpha]]
    y[t] = alpha*z1[t] - beta*z2[t]

where ``alpha = E cos K``, ``beta = E sin K`` (``M = E R(K)``, a scaled
rotation) and ``u`` is the FIR part.  The companion matrix
``[[-a1, -a2], [1, 0]]`` is the same recurrence but tree-unstable in
float32 (``apda_fft_tpu/ops/srs.py:19-41``): products of scaled rotations
stay orthogonal-times-scalar at every level.

PyTorch has no associative scan, so the recurrence is a log-depth inclusive
scan by doubling (Hillis-Steele) over the time axis: at level ``k`` every
``z[t]`` with ``t >= s = 2^k`` gains ``M^s z[t - s]``.  Every element of a
level shares one matrix, ``M^s = E^s R(sK)``, so its entries are computed on
the host in float64 and rounded once: ``ceil(log2 T)`` levels of a few
elementwise passes over ``[..., T, F]`` (time x frequency bank), never a
Python loop over time.  Coefficients are float64 on the host; only the
recurrence runs in float32 on the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import _from_host
from apda_fft_tpu_torch.ops.integrate import _float_records


def srs_frequencies(f_min: float, f_max: float, points_per_octave: int = 6) -> np.ndarray:
    """Log-spaced SDOF natural-frequency bank, ``points_per_octave`` per octave.

    Includes ``f_min`` exactly; the last point is the largest grid point
    ``<= f_max`` (plus ``f_max`` itself if the grid undershoots by more than
    1%), the standard 1/6-octave grid.
    """
    if f_min <= 0 or f_max <= f_min:
        raise ValueError(f"need 0 < f_min < f_max, got ({f_min}, {f_max})")
    if points_per_octave < 1:
        raise ValueError(f"points_per_octave must be >= 1, got {points_per_octave}")
    n_oct = math.log2(f_max / f_min)
    n = int(math.floor(n_oct * points_per_octave)) + 1
    freqs = f_min * (2.0 ** (np.arange(n) / points_per_octave))
    if f_max / freqs[-1] > 1.01:
        freqs = np.append(freqs, f_max)
    return freqs


def _sdof_params(freqs: np.ndarray, fs: float,
                 q: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-oscillator ``(E, E cos K, E sin K)`` in float64: ``E = exp(-zeta
    wn dt)`` the per-sample decay, ``K = wd dt`` the damped phase advance."""
    freqs = np.asarray(freqs, np.float64)
    if np.any(freqs <= 0) or np.any(freqs >= fs / 2):
        raise ValueError("SRS bank frequencies must lie in (0, fs/2)")
    zeta = 1.0 / (2.0 * q)
    dt = 1.0 / float(fs)
    wn = 2.0 * np.pi * freqs
    k = wn * np.sqrt(1.0 - zeta * zeta) * dt
    e = np.exp(-zeta * wn * dt)
    return e, e * np.cos(k), e * np.sin(k)


def smallwood_coefficients(freqs: np.ndarray, fs: float,
                           q: float = 10.0) -> tuple[np.ndarray, np.ndarray]:
    """ISO 18431-4 ramp-invariant SDOF filter coefficients, float64.

    Returns ``(b, a)`` of shapes ``[3, F]`` (``a[0] == 1``): base
    acceleration in, oscillator absolute acceleration out.
    """
    freqs = np.asarray(freqs, np.float64)
    e, c, s = _sdof_params(freqs, fs, q)
    zeta = 1.0 / (2.0 * q)
    k = 2.0 * np.pi * freqs * np.sqrt(1.0 - zeta * zeta) / float(fs)
    sp = s / k
    b = np.stack([1.0 - sp, 2.0 * (sp - c), e * e - sp])
    a = np.stack([np.ones_like(c), -2.0 * c, e * e])
    return b, a


def _rotation_powers(freqs: np.ndarray, fs: float, q: float, t: int) -> np.ndarray:
    """``[L, 2, F]`` float64: ``(E^s cos sK, E^s sin sK)`` for the scan's
    offsets ``s = 1, 2, 4, ... < t`` - the entries of ``M^s``."""
    zeta = 1.0 / (2.0 * q)
    wn = 2.0 * np.pi * np.asarray(freqs, np.float64)
    k = wn * np.sqrt(1.0 - zeta * zeta) / float(fs)
    log_e = -zeta * wn / float(fs)
    s = 2.0 ** np.arange(max(t - 1, 1).bit_length())[:, None]
    mag = np.exp(s * log_e)
    return np.stack([mag * np.cos(s * k), mag * np.sin(s * k)], axis=1)


def _srs_impl(x: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
              powers: torch.Tensor, *, pad: int) -> torch.Tensor:
    """``[3, ..., F]``: maximax, positive and negative SRS of ``x`` over the
    bank.  ``b [3, F]`` FIR coefficients, ``alpha``/``beta [F]`` the rotation
    entries, ``powers [L, 2, F]`` the entries of ``M^(2^k)``."""
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    # FIR part, fully parallel: u[t] = b0 x[t] + b1 x[t-1] + b2 x[t-2].
    xm1 = torch.nn.functional.pad(x[..., :-1], (1, 0))
    xm2 = torch.nn.functional.pad(x[..., :-2], (2, 0))
    u = x[..., None] * b[0] + xm1[..., None] * b[1] + xm2[..., None] * b[2]  # [..., T, F]
    t = u.shape[-2]
    z1 = torch.zeros_like(u)
    z2 = -u / beta
    for k in range(powers.shape[0]):
        s = 1 << k
        if s >= t:
            break
        a_s, b_s = powers[k]
        p1, p2 = z1[..., : t - s, :], z2[..., : t - s, :]
        # Every z[t] with t >= s gains M^s z[t - s] (old values on the right).
        z1 = z1 + torch.nn.functional.pad(a_s * p1 - b_s * p2, (0, 0, s, 0))
        z2 = z2 + torch.nn.functional.pad(b_s * p1 + a_s * p2, (0, 0, s, 0))
    y = alpha * z1 - beta * z2
    return torch.stack([y.abs().amax(dim=-2), y.amax(dim=-2), y.amin(dim=-2)])


@dataclasses.dataclass(frozen=True)
class SRSResult:
    """SRS over a frequency bank; arrays are batch-shaped ``[..., F]``.

    ``maximax`` is the classic reported spectrum (largest absolute
    oscillator acceleration over primary + residual phases, input units);
    ``positive`` / ``negative`` are the signed extremes.  ``pseudo_velocity``
    is ``maximax / wn``.
    """

    freqs: np.ndarray
    maximax: np.ndarray
    positive: np.ndarray
    negative: np.ndarray
    q: float

    @property
    def pseudo_velocity(self) -> np.ndarray:
        return self.maximax / (2.0 * np.pi * self.freqs)

    def peak(self) -> tuple[float, float]:
        """(frequency, maximax value) of the spectrum's largest entry; a
        batched result reduces over the whole batch."""
        mm = np.asarray(self.maximax)
        flat = mm.reshape(-1, mm.shape[-1])
        i = int(np.argmax(np.max(flat, axis=0)))
        return float(self.freqs[i]), float(np.max(flat[:, i]))


def shock_response_spectrum(
    x,
    fs: float,
    freqs=None,
    *,
    q: float = 10.0,
    f_min: float | None = None,
    f_max: float | None = None,
    points_per_octave: int = 6,
    residual: bool = True,
    device: torch.device | str | None = None,
) -> SRSResult:
    """Shock Response Spectrum of transient(s) ``x`` (``[..., T]``, any units).

    Args:
      x: base-acceleration record(s); last axis is time.  A tensor runs
        where it lies, an array on ``device`` (default the card).
      fs: sampling rate in Hz.
      freqs: explicit natural-frequency bank (Hz).  Default: a
        ``points_per_octave`` log grid from ``f_min`` (default ``fs/100``)
        to ``f_max`` (default ``fs/4``).
      q: oscillator quality factor (``zeta = 1/(2q)``).
      residual: include the free-decay phase after the record ends by
        zero-padding one period of the slowest oscillator.

    Returns:
      ``SRSResult`` with host numpy spectra ``[..., F]``, the bank and the
      pseudo-velocity.
    """
    x = _float_records(x, device)
    if x.shape[-1] < 3:
        raise ValueError("SRS needs at least 3 samples")
    if freqs is None:
        lo = f_min if f_min is not None else fs / 100.0
        hi = f_max if f_max is not None else fs / 4.0
        freqs = srs_frequencies(lo, hi, points_per_octave)
    freqs = np.asarray(freqs, np.float64)
    b, _ = smallwood_coefficients(freqs, fs, q)
    _, alpha, beta = _sdof_params(freqs, fs, q)
    pad = int(math.ceil(fs / float(freqs.min()))) if residual else 0
    powers = _rotation_powers(freqs, fs, q, x.shape[-1] + pad)
    dev, dt = x.device, x.dtype
    out = _srs_impl(x, _from_host(b, dev, dt), _from_host(alpha, dev, dt),
                    _from_host(beta, dev, dt), _from_host(powers, dev, dt), pad=pad)
    mm, pos, neg = out.cpu().numpy()
    return SRSResult(freqs=freqs, maximax=mm, positive=pos, negative=neg, q=float(q))
