"""Quickstart: batch-analyze an epoch of accelerometer windows.

Run: python -m apda_fft_tpu_torch.examples.quickstart [--device cpu]
"""

import os
import sys

# Runnable from anywhere without installation: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

import apda_fft_tpu_torch as apda
from apda_fft_tpu_torch.examples import parse_device


def main(device: str | None = None) -> None:
    fs = 500.0  # Hz
    n = 4096
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)

    # An epoch: 3 channels x 8 windows of a two-mode structure + noise.
    base = np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
    samples = (base + 0.05 * rng.standard_normal((3, 8, n))).astype(np.float32)

    result = apda.analyze_epoch(samples, fs, mode="flexible", refine=True, device=device)

    print(f"epoch batch shape: {samples.shape} -> window 0 of each channel:")
    for c in range(samples.shape[0]):
        count = int(result.count[c, 0])
        freqs = result.freq[c, 0].cpu().numpy()[:count]
        damps = result.damping[c, 0].cpu().numpy()[:count]
        print(f"  ch{c}: {count} peaks at {freqs} Hz, damping {damps} %")
    per_window = result.count.cpu().numpy()
    print(f"all {per_window.size} windows found peaks: "
          f"min {per_window.min()}, max {per_window.max()} per window")

    # A single window on the card routes through the single-window kernels
    # automatically (analyze_epoch(lowlat="auto") is the default).
    one = apda.analyze_epoch(samples[0, 0][None], fs, device=device)
    print(f"single-window: {int(one.count[0])} peaks, "
          f"top {float(one.freq[0][0]):.4f} Hz")


if __name__ == "__main__":
    main(parse_device(__doc__))
