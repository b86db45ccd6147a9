"""Anti-aliased integer decimation and rational resampling - mixed-ODR fusion.

Counterpart of ``apda_fft_tpu/ops/resample.py``.  Cross-sensor analysis
(FDD mode shapes, SSI, coherence) needs every channel on one time base;
these functions bring a faster channel down to a slower channel's rate
without aliasing its out-of-band content into the shared band.

The polyphase FIR is one strided ``conv1d`` over the whole ``[S, T]`` batch,
run in IEEE float32 (``ops.fft.ieee_fp32_matmul`` pins cuDNN's and oneDNN's
convolutions; TF32 would cost the ~90 dB alias floor).  The windowed-sinc
taps are designed on the host in float64.  Semantics match
``scipy.signal.resample_poly(x, up, down, window=taps)``: the same
even-symmetric kernel, zero-padded edges and output grid.  Results are host
float64 numpy, as in the JAX package; the records run where a tensor lies,
or an array on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import gcd

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import _from_host, _placed
from apda_fft_tpu_torch.ops.fft import ieee_fp32_matmul

__all__ = [
    "decimate",
    "design_decimation_taps",
    "decimation_factor",
    "rational_factors",
    "resample_rational",
]


def decimation_factor(fs_from: float, fs_to: float, *, rel_tol: float = 1e-6):
    """Integer factor ``q`` with ``fs_from == q * fs_to``, else ``None``."""
    fs_from = float(fs_from)
    fs_to = float(fs_to)
    if fs_to <= 0 or fs_from <= 0:
        return None
    q = fs_from / fs_to
    qi = int(round(q))
    if qi < 1 or abs(q - qi) > rel_tol * q:
        return None
    return qi


def rational_factors(fs_from: float, fs_to: float, *, max_den: int = 64):
    """Smallest ``(up, down)`` with ``fs_from * up / down == fs_to``.

    ``None`` when no rational relation with denominator <= ``max_den``
    exists (within 1e-9 relative), e.g. ``(5, 8)`` for 100 -> 62.5 Hz.
    """
    fs_from = float(fs_from)
    fs_to = float(fs_to)
    if fs_from <= 0 or fs_to <= 0:
        return None
    frac = Fraction(fs_to / fs_from).limit_denominator(max_den)
    if frac.numerator < 1:
        return None
    if abs(float(frac) * fs_from - fs_to) > 1e-9 * fs_to:
        return None
    return frac.numerator, frac.denominator


@functools.lru_cache(maxsize=64)
def design_decimation_taps(q: int, ntaps_per_phase: int = 12,
                           cutoff_rel: float = 0.8) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass for decimation by ``q`` (float64).

    Cutoff ``cutoff_rel / (2q)`` cycles/sample, ``2 * ntaps_per_phase * q +
    1`` taps (odd: exactly linear phase, integer group delay), Kaiser
    ``beta=8.6`` (~90 dB stopband), unit DC gain.
    """
    if q < 1:
        raise ValueError(f"decimation factor must be >= 1, got {q}")
    if ntaps_per_phase < 2:
        raise ValueError(f"ntaps_per_phase must be >= 2, got {ntaps_per_phase}")
    if not 0.0 < cutoff_rel <= 1.0:
        raise ValueError(f"cutoff_rel must be in (0, 1], got {cutoff_rel}")
    length = 2 * ntaps_per_phase * q + 1
    n = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    fc = cutoff_rel / (2.0 * q)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(length, 8.6)
    return h / h.sum()


@functools.lru_cache(maxsize=64)
def _rational_taps(up: int, down: int, ntaps_per_phase: int,
                   cutoff_rel: float) -> np.ndarray:
    """Lowpass for rational resampling on the ``up``-dilated grid: cutoff
    ``cutoff_rel / (2 * max(up, down))`` cycles/up-sample, gain ``up``."""
    m = max(up, down)
    length = 2 * ntaps_per_phase * m + 1
    n = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    fc = cutoff_rel / (2.0 * m)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(length, 8.6)
    return h / h.sum() * up


def _fir(x: torch.Tensor, taps: np.ndarray, *, up: int, down: int, n_out: int) -> torch.Tensor:
    """``[B, T]`` -> ``[B, n_out]``: zero-stuff by ``up`` (the JAX package's
    ``lhs_dilation``), pad ``(half, half + up + down)`` (``up == 1``: ``(half,
    half + down - 1)``), and one strided ``conv1d`` with the flipped taps."""
    half = (len(taps) - 1) // 2
    if up > 1:
        z = x.new_zeros(x.shape[0], (x.shape[-1] - 1) * up + 1)
        z[:, ::up] = x
        x = z
        right = half + up + down
    else:
        right = half + down - 1
    w = _from_host(np.ascontiguousarray(taps[::-1]), x.device, x.dtype)
    xp = torch.nn.functional.pad(x, (half, right))[:, None, :]
    with ieee_fp32_matmul():
        out = torch.nn.functional.conv1d(xp, w[None, None, :], stride=down)
    return out[:, 0, :n_out]


def _run(records, taps: np.ndarray, *, up: int, down: int, n_out: int, dtype,
         device) -> np.ndarray:
    x = _placed(records, device, dtype)
    lead, t = tuple(x.shape[:-1]), x.shape[-1]
    y = _fir(x.reshape(-1, t), taps, up=up, down=down, n_out=n_out)
    return y.cpu().numpy().astype(np.float64).reshape(lead + (n_out,))


def _host_float64(records) -> np.ndarray:
    if isinstance(records, torch.Tensor):
        return records.detach().cpu().numpy().astype(np.float64)
    return np.asarray(records, np.float64)


def resample_rational(records, up: int, down: int, *, ntaps_per_phase: int = 12,
                      cutoff_rel: float = 0.8, dtype: torch.dtype = torch.float32,
                      device: torch.device | str | None = None) -> np.ndarray:
    """Rational-rate resampling of ``[..., T]`` records by ``up / down``.

    ``scipy.signal.resample_poly`` semantics: output sample ``n`` is the
    band-limited signal at ``t = n * down / (up * fs)``, length
    ``ceil(T * up / down)``.  Covers the non-dyadic rate pairs
    :func:`decimate` cannot (e.g. 100 -> 62.5 Hz via ``up=5, down=8``).
    Returns host float64 numpy.
    """
    up = int(up)
    down = int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got ({up}, {down})")
    if ntaps_per_phase < 2:
        raise ValueError(f"ntaps_per_phase must be >= 2, got {ntaps_per_phase}")
    if not 0.0 < cutoff_rel <= 1.0:
        raise ValueError(f"cutoff_rel must be in (0, 1], got {cutoff_rel}")
    g = gcd(up, down)
    up //= g
    down //= g
    shape = tuple(records.shape) if hasattr(records, "shape") else np.shape(records)
    if len(shape) == 0:
        raise ValueError("records must have a time axis")
    t = shape[-1]
    if up == 1 and down == 1:
        return _host_float64(records)
    if t < 2 * down:
        raise ValueError(f"record too short to resample by {up}/{down}: T={t}")
    taps = _rational_taps(up, down, ntaps_per_phase, cutoff_rel)
    return _run(records, taps, up=up, down=down, n_out=-(-t * up // down), dtype=dtype,
                device=device)


def decimate(records, q: int, *, ntaps_per_phase: int = 12, cutoff_rel: float = 0.8,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str | None = None) -> np.ndarray:
    """Anti-aliased decimation of ``[..., T]`` records by integer ``q``.

    Output sample ``n`` is the lowpass-filtered input at position ``n*q``
    (zero-phase: the FIR's integer group delay is folded into the padding),
    length ``ceil(T / q)`` - the grid ``scipy.signal.resample_poly(x, 1, q)``
    uses.  ``q=1`` is the identity (no filtering).  Returns host float64
    numpy.
    """
    q = int(q)
    if q < 1:
        raise ValueError(f"decimation factor must be >= 1, got {q}")
    shape = tuple(records.shape) if hasattr(records, "shape") else np.shape(records)
    if len(shape) == 0:
        raise ValueError("records must have a time axis")
    if q == 1:
        return _host_float64(records)
    t = shape[-1]
    if t < 2 * q:
        raise ValueError(f"record too short to decimate by {q}: T={t}")
    taps = design_decimation_taps(q, ntaps_per_phase, cutoff_rel)
    return _run(records, taps, up=1, down=q, n_out=-(-t // q), dtype=dtype, device=device)
