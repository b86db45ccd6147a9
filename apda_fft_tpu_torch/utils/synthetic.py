"""Synthetic structural response with known modal ground truth.

Counterpart of ``apda_fft_tpu/utils/synthetic.py``: white-noise-driven SDOF
modal coordinates mixed through a mode-shape matrix, the textbook
output-only identification setup that the modal tests and ``chip_smoke.py``
drive :func:`~apda_fft_tpu_torch.models.modal.fdd` and
:func:`~apda_fft_tpu_torch.models.ssi.ssi` with.  Host numpy: it makes the
input data.
"""

from __future__ import annotations

import numpy as np


def modal_records(
    shapes,
    freqs_hz,
    zetas,
    fs: float,
    t_sec: float,
    seed: int = 0,
    sensor_noise: float = 0.02,
) -> np.ndarray:
    """``[S, T]`` float32 responses with known modal ground truth.

    Each mode ``(f, zeta)`` is a discretized SDOF resonator - an AR(2)
    process with poles ``exp((-zeta*w +/- i*w*sqrt(1-zeta^2))/fs)`` - driven
    by independent unit white noise; the ``[n_modes, T]`` coordinates are
    mixed through the ``[n_modes, S]`` ``shapes`` matrix and independent
    sensor noise of ``sensor_noise * std`` is added.
    """
    import scipy.signal

    shapes = np.atleast_2d(np.asarray(shapes, np.float64))
    rng = np.random.default_rng(seed)
    n = int(t_sec * fs)
    qs = []
    for f, z in zip(freqs_hz, zetas):
        w = 2.0 * np.pi * f
        r = np.exp(-z * w / fs)
        th = w * np.sqrt(1.0 - z * z) / fs
        a1, a2 = 2.0 * r * np.cos(th), -(r * r)
        qs.append(scipy.signal.lfilter([1.0], [1.0, -a1, -a2], rng.standard_normal(n)))
    x = shapes.T @ np.stack(qs)
    x += sensor_noise * np.std(x) * rng.standard_normal(x.shape)
    return x.astype(np.float32)
