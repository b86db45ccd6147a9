"""Field realities: machinery harmonics and mixed-ODR sensor arrays.

Two pitfalls every deployed monitoring array hits sooner or later:

1. **Machinery harmonics.** An HVAC fan or generator injects a
   deterministic sine that FDD happily reports as a "mode".  The
   narrowband-kurtosis indicator separates them: a sinusoid's
   band-filtered response has an arcsine density (kurtosis ~1.5), a
   stochastically excited structural mode is Gaussian (~3.0).
2. **Mixed output data rates.**  A deck node at 250 Hz next to a pylon
   node at 125 Hz: cross-sensor analysis needs one time base, so the
   faster channel is anti-alias decimated onto the slower rate
   (`ops/resample.py` - one strided convolution, scipy-exact grid).

Run: python -m apda_fft_tpu_torch.examples.harmonics_and_mixed_rates [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from apda_fft_tpu_torch.examples import parse_device
from apda_fft_tpu_torch.models.modal import fdd, harmonic_indicator
from apda_fft_tpu_torch.ops.resample import decimate, decimation_factor
from apda_fft_tpu_torch.utils.synthetic import modal_records

FS = 250.0          # fast sensors' rate
T_SEC = 120.0
F_MODE = 9.3        # true structural mode (2% damping)
F_HARM = 30.7       # machinery line


def main(device: str | None = None) -> None:
    # Three sensors observing one structural mode...
    x = modal_records(np.array([[0.5, 1.0, -0.8]]), [F_MODE], [0.02], FS, T_SEC,
                      seed=1)
    x /= x.std()
    # ...plus a machinery harmonic coupling into all of them.
    t = np.arange(x.shape[-1]) / FS
    x += 0.7 * np.array([1.0, 0.8, 1.1])[:, None] * np.sin(2 * np.pi * F_HARM * t)

    # --- 1. Which "modes" are real? ---------------------------------------
    res = fdd(x.astype(np.float32), FS, window=1024, harmonics=True, device=device)
    n = int(res.count)
    mask = res.harmonic_mask()
    print(f"FDD found {n} candidate modes:")
    for i in range(n):
        tag = "MACHINERY HARMONIC" if mask[i] else "structural mode"
        print(f"  f={res.freq[i]:8.4f} Hz  kurtosis={res.kurtosis[i]:.2f}  "
              f"-> {tag}")

    # The indicator also works standalone on any frequency list:
    kap = harmonic_indicator(x, FS, [F_MODE, F_HARM], window=1024, device=device)
    print(f"standalone kurtosis: mode={kap[0]:.2f}, harmonic={kap[1]:.2f}")

    # --- 2. Fusing a mixed-rate array -------------------------------------
    # Sensors 0-1 actually report at 125 Hz (every 2nd sample); sensor 2
    # stays at 250 Hz.  Decimate the fast one onto the slow time base and run
    # one cross-sensor decomposition.
    fs_slow = FS / 2
    q = decimation_factor(FS, fs_slow)
    slow = x[:2, ::2]
    fast_on_slow = decimate(x[2], q, device=device)[: slow.shape[1]]
    fused = np.vstack([slow, fast_on_slow[None, :]]).astype(np.float32)
    res2 = fdd(fused, fs_slow, window=1024, device=device)
    n2 = int(res2.count)
    i = int(np.argmin(np.abs(res2.freq[:n2] - F_MODE)))
    shape = np.abs(res2.shapes()[i])
    print(f"\nmixed-rate array fused at {fs_slow:g} Hz: mode at "
          f"{res2.freq[i]:.4f} Hz, |shape|={np.round(shape / shape.max(), 3)}")


if __name__ == "__main__":
    main(parse_device(__doc__))
