"""``sensor_windows``: a seeded pool of accelerometer windows from a
traffic mix's ``"signal"`` parameters.

The parameters describe one window of acceleration sampled at the
configuration's rate, the models of ``bench.py``'s two corpora written as
data:

* ``noise_std``: white Gaussian noise;
* ``offset``: a constant added to every sample;
* ``tones``: ``[freq_hz, amplitude]`` sines of phase 0;
* ``modes``: ``[freq_hz, amplitude, zeta]`` damped sines
  ``a * sin(2 pi f t + phi) * exp(-zeta 2 pi f t)``, each with a phase
  drawn per window from U(0, 2 pi).

The same seed gives the same pool, bit for bit, and every seed the same
sizes.  The noise is drawn first, then the phases mode by mode, all in
float32.
"""

from __future__ import annotations

import numpy as np


def make_pool(signal: dict, *, rows: int, n: int, fs: float, seed: int) -> np.ndarray:
    """``[rows, n]`` float32 host windows for ``seed``."""
    rng = np.random.default_rng(seed)
    t = (np.arange(n, dtype=np.float64) / fs)
    x = rng.standard_normal((rows, n), dtype=np.float32)
    x *= np.float32(signal.get("noise_std", 1.0))
    base = np.full(n, signal.get("offset", 0.0), np.float64)
    for f, a in signal.get("tones", []):
        base += a * np.sin(2 * np.pi * f * t)
    x += base.astype(np.float32)[None, :]
    for f, a, zeta in signal.get("modes", []):
        phase = rng.uniform(0.0, 2 * np.pi, size=rows)
        env = a * np.exp(-zeta * 2 * np.pi * f * t)
        # sin(wt + phi) = sin(wt) cos(phi) + cos(wt) sin(phi): two outer
        # products instead of a sine per sample.
        s = (env * np.sin(2 * np.pi * f * t)).astype(np.float32)
        c = (env * np.cos(2 * np.pi * f * t)).astype(np.float32)
        x += np.cos(phase).astype(np.float32)[:, None] * s[None, :]
        x += np.sin(phase).astype(np.float32)[:, None] * c[None, :]
    return x
