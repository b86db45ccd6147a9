"""Free-decay (ring-down) damping estimation - the shock-transient story.

Counterpart of ``apda_fft_tpu/ops/ringdown.py``.  A shock transient is free
decay, ``x(t) ~ A exp(-zeta w0 t) sin(wd t + phi)``; the textbook estimator
is the logarithmic decrement: band-select the modal line in the frequency
domain, take the analytic signal by the half-spectrum trick (Hilbert), and
fit a line to the log envelope by weighted least squares in float32.

``ringdown_damping`` runs a tensor where it lies and an array or list on
the card unless ``device="cpu"`` is given; ``fs`` and ``f0`` are scalars or
batch-shaped, and the result is a batch-shaped tensor on that device.
"""

from __future__ import annotations

import math

import torch

from apda_fft_tpu_torch.models.pipeline import _fs_tensor
from apda_fft_tpu_torch.ops.fft import next_pow2
from apda_fft_tpu_torch.ops.integrate import _float_records, _mean_centred
from apda_fft_tpu_torch.ops.stats import div_exact


def _ringdown_impl(x: torch.Tensor, fs: torch.Tensor, f0: torch.Tensor, *, n_fft: int,
                   band_rel: float) -> tuple[torch.Tensor, torch.Tensor]:
    dtype = x.dtype
    n = x.shape[-1]
    # Analytic signal restricted to the modal band: FFT, keep positive
    # frequencies within band_rel of f0 (doubled), inverse FFT.  Mean-centre
    # first (free decay rides on the sensor's DC offset).
    xc = _mean_centred(x)
    if n < n_fft:
        xc = torch.nn.functional.pad(xc, (0, n_fft - n))
    spec = torch.fft.fft(xc)
    # freqs broadcasts over batched fs/f0: [..., n_fft].
    freqs = torch.arange(n_fft, dtype=dtype, device=x.device) * div_exact(fs[..., None],
                                                                         float(n_fft))
    lo = (f0 * (1.0 - band_rel))[..., None]
    hi = (f0 * (1.0 + band_rel))[..., None]
    # Strictly below Nyquist: bins at/above fs/2 are the conjugate half.
    band = (freqs >= lo) & (freqs <= hi) & (freqs < fs[..., None] * 0.5)
    analytic = torch.fft.ifft(torch.where(band, spec * 2.0, 0.0))[..., :n]
    env = analytic.abs().to(dtype)

    # Fit log(env) from the envelope peak to the first sample after it that
    # drops below 5% of the peak; weighted least squares with the mask.
    peak_i = torch.argmax(env, dim=-1, keepdim=True)
    peak_v = torch.gather(env, -1, peak_i)
    iota = torch.arange(n, device=x.device)
    above = env > 0.05 * peak_v
    after = iota >= peak_i
    below_after = after & ~above
    # argmax of an integer mask: its first True (index 0 when there is none).
    first_below = torch.where(below_after.any(dim=-1, keepdim=True),
                              torch.argmax(below_after.to(torch.int32), dim=-1, keepdim=True),
                              n)
    fit = after & above & (iota < first_below)

    t = iota.to(dtype) / fs[..., None]
    logy = torch.log(torch.clamp(env, min=1e-30))
    w = fit.to(dtype)
    sw = w.sum(dim=-1)
    swx = (w * t).sum(dim=-1)
    swy = (w * logy).sum(dim=-1)
    swxx = (w * t * t).sum(dim=-1)
    swxy = (w * t * logy).sum(dim=-1)
    denom = sw * swxx - swx * swx
    slope = torch.where(denom != 0, (sw * swxy - swx * swy) / denom, 0.0)
    # x(t) ~ exp(-zeta*w0*t): slope = -zeta*2*pi*f0 (light damping: wd ~ w0).
    zeta = torch.where(f0 > 0, -slope / (2.0 * math.pi * f0), 0.0)
    return zeta, sw


def ringdown_damping(x, fs, f0, band_rel: float = 0.2, min_cycles: float = 3.0, *,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Damping ratio ``zeta`` of a free-decay transient by log decrement.

    Args:
      x: ``[..., N]`` transient record(s).
      fs: sampling rate (Hz), scalar or broadcastable.
      f0: modal frequency (Hz) to band-select, e.g. the detected peak
        (scalar or batch-shaped).
      band_rel: half-bandwidth of the modal band as a fraction of ``f0``.
      min_cycles: estimates whose fit window spans fewer oscillation cycles
        than this are NaN (too short to trust).
      device: where an array runs (default the card).

    Returns:
      ``zeta`` (damping ratio, NOT percent), batch-shaped.
    """
    x = _float_records(x, device)
    fs_t = _fs_tensor(fs, x.dtype, x.device)
    f0_t = _fs_tensor(f0, x.dtype, x.device)
    zeta, n_fit = _ringdown_impl(x, fs_t, f0_t, n_fft=next_pow2(x.shape[-1]),
                                 band_rel=band_rel)
    cycles = n_fit / fs_t * f0_t
    return torch.where(cycles >= min_cycles, zeta, math.nan)
