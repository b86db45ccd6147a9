"""Leakage control and noise averaging: tapers, Welch, spectrogram.

Run: python -m apda_fft_tpu_torch.examples.welch_and_taper [--device cpu]
"""

import os
import sys

# Runnable from anywhere without installation: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

import apda_fft_tpu_torch as apda
from apda_fft_tpu_torch.examples import parse_device


def main(device: str | None = None) -> None:
    fs = 500.0
    rng = np.random.default_rng(1)

    # --- Tapers: resolve a weak tone next to a strong off-bin neighbor ----
    n = 4096
    df = fs / n
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * (300.5 * df) * t)          # strong, off-bin
         + 0.12 * np.sin(2 * np.pi * (330 * df) * t)   # weak neighbor
         ).astype(np.float32)[None]
    for taper in ("none", "hann"):
        res = apda.analyze_epoch(x, fs, taper=taper, device=device)
        c = int(res.count[0])
        print(f"taper={taper:5s}: peaks at bins "
              f"{[int(i) for i in res.idx[0].cpu().numpy()[:c]]}")

    # --- Welch averaging: pull a -22 dB tone out of white noise ----------
    T = 1 << 18
    tt = np.arange(T) / fs
    long_rec = (0.08 * np.sin(2 * np.pi * 25.0 * tt)
                + rng.standard_normal(T)).astype(np.float32)
    w = apda.analyze_welch(long_rec, fs, window=4096, device=device)  # 50% overlap, hann
    print(f"welch over {T} samples: top peak {float(w.freq[0]):.3f} Hz "
          f"(true 25.0 Hz), {int(w.count)} peaks")

    # --- Spectrogram: time-frequency magnitudes --------------------------
    freqs, mags = apda.spectrogram(long_rec, fs, window=2048, taper="hann", device=device)
    print(f"spectrogram: {mags.shape[0]} frames x {mags.shape[1]} bins, "
          f"df={float(freqs[1]):.3f} Hz")

    # --- Coherence: do two sensors see the same mode? --------------------
    t2 = np.arange(1 << 16) / fs
    shared = np.sin(2 * np.pi * 40.0 * t2)
    s1 = (shared + 0.5 * rng.standard_normal(t2.size)).astype(np.float32)
    s2 = (0.7 * np.sin(2 * np.pi * 40.0 * t2 - np.pi / 4)
          + 0.5 * rng.standard_normal(t2.size)).astype(np.float32)
    cf, cxy = apda.coherence(s1, s2, fs, window=1024, device=device)
    _, pxy = apda.cross_psd(s1, s2, fs, window=1024, device=device)
    cf, cxy, pxy = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (cf, cxy, pxy))
    b = int(np.argmin(np.abs(cf - 40.0)))  # bin nearest 40 Hz
    print(f"coherence at the shared 40 Hz mode: {float(cxy[b]):.3f} "
          f"(noise floor {float(cxy[b+30:b+200].mean()):.3f}); "
          f"cross-phase {float(np.angle(pxy[b])):+.3f} rad")


if __name__ == "__main__":
    main(parse_device(__doc__))
