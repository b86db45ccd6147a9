"""The full SHM monitoring loop: epochs -> peaks -> tracks -> drift alert.

Simulates a structure whose first mode slowly loses stiffness (frequency
drifting down ~0.5%/epoch) while the second mode stays put, analyzes each
acquisition epoch on the card, and feeds the detected peaks into a
PeakTracker until the drift alert fires.

Run: python -m apda_fft_tpu_torch.examples.drift_monitoring [--device cpu]
"""

import os
import sys

# Runnable from anywhere without installation: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

import apda_fft_tpu_torch as apda
from apda_fft_tpu_torch.examples import parse_device


def main(device: str | None = None) -> None:
    fs, n = 500.0, 4096
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)
    tracker = apda.PeakTracker(rel_tol=0.02)

    for epoch in range(16):
        f1 = 25.0 * (1 - 0.005 * epoch)  # slow stiffness loss
        x = (np.sin(2 * np.pi * f1 * t)
             + 0.6 * np.sin(2 * np.pi * 47.7 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        result = apda.analyze_epoch(x[None], fs, mode="flexible", refine=True, device=device)
        tracker.update(result, t=epoch)

        alerts = tracker.alerts(rel_drift=0.02, min_length=5)
        if alerts:
            tr = alerts[0]
            print(f"epoch {epoch}: ALERT - mode near {tr.mean_freq:.2f} Hz "
                  f"drifted {tr.drift_relative * 100:+.2f}% "
                  f"({tr.freqs[0]:.3f} -> {tr.freqs[-1]:.3f} Hz)")
            break
    else:
        print("no alert fired")

    print("\nall tracks:")
    for tr in tracker.tracks(min_length=2):
        print(f"  track {tr.track_id}: {len(tr)} epochs, "
              f"mean {tr.mean_freq:.3f} Hz, drift {tr.drift_hz:+.4f} Hz")


if __name__ == "__main__":
    main(parse_device(__doc__))
