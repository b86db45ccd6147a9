"""Serviceability quantities: vibration severity, integration, shock SRS.

The reference gateway uploads raw acceleration traces and leaves the
numbers a maintenance standard acts on to the server side.  This demo
computes them directly: ISO 10816/20816 vibration severity (band-limited
velocity RMS in mm/s), leakage-controlled frequency-domain integration
(velocity / displacement traces), and the Shock Response Spectrum of a
transient (damage potential).

Run: python -m apda_fft_tpu_torch.examples.severity_and_shock [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

import apda_fft_tpu_torch as apda
from apda_fft_tpu_torch.examples import parse_device


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def main(device: str | None = None) -> None:
    fs = 500.0
    n = 4096
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)

    # A machine-like vibration record: 25 Hz line + broadband floor (g).
    a0 = 0.15
    x = (a0 * np.sin(2 * np.pi * 25.0 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)

    # ISO vibration severity: band-limited velocity RMS, g*s -> mm/s.
    mms = float(apda.velocity_rms(x, fs, band=(10.0, 200.0), device=device)) * apda.G_TO_MMS2
    analytic = a0 / (2 * np.pi * 25.0) / np.sqrt(2) * apda.G_TO_MMS2
    print(f"vibration severity: {mms:.2f} mm/s RMS "
          f"(analytic for the tone alone: {analytic:.2f})")
    for zone, limit in (("A/B (good)", 4.5), ("B/C (alert)", 7.1),
                        ("C/D (shutdown)", 11.0)):
        print(f"  ISO class-III zone {zone:16s} {limit:5.1f} mm/s: "
              f"{'OVER' if mms >= limit else 'ok'}")

    # Integration: velocity and displacement traces (read the flat middle;
    # the Tukey taper + soft high-pass control off-bin leakage).
    v = _host(apda.velocity(x, fs, device=device))
    d = _host(apda.displacement(x, fs, device=device))
    mid = slice(n // 4, 3 * n // 4)
    print(f"velocity peak (mid): {np.max(np.abs(v[mid])) * apda.G_TO_MMS2:.3f} mm/s, "
          f"displacement peak: {np.max(np.abs(d[mid])) * apda.G_TO_MMS2 * 1e3:.2f} um")

    # Shock Response Spectrum of a 20 Hz ring-down transient.
    td = np.arange(512) / fs
    shock = (2.0 * np.exp(-6.0 * td) * np.sin(2 * np.pi * 20.0 * td)
             ).astype(np.float32)
    res = apda.shock_response_spectrum(shock, fs, device=device)
    f_pk, a_pk = res.peak()
    pv = float(np.max(_host(res.pseudo_velocity))) * apda.G_TO_MMS2
    print(f"shock SRS: peak {a_pk:.2f} g @ {f_pk:.1f} Hz oscillator "
          f"(Q={res.q:g}), pseudo-velocity {pv:.1f} mm/s")


if __name__ == "__main__":
    main(parse_device(__doc__))
