"""Run the full gateway state machine against simulated sensors.

The simulator speaks the reference wire protocol (0xA1 sync, 0xD1-0xD3
streams, fault injection) through the same GatewayService that drives real
XBee hardware; completed acquisitions flow through the spectral pipeline on
the card and the history log shows the decoded telemetry + detected peaks.

Run: python -m apda_fft_tpu_torch.examples.gateway_simulation [--device cpu]
(equivalent to: python -m apda_fft_tpu_torch.gateway --simulate --sensors 2)
"""

import os
import sys

# Runnable from anywhere without installation: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from apda_fft_tpu_torch.examples import parse_device
from apda_fft_tpu_torch.gateway.__main__ import main as gateway_main


def main(device: str | None = None) -> None:
    argv = ["--simulate", "--sensors", "2"]
    gateway_main(argv + (["--device", device] if device else []))


if __name__ == "__main__":
    main(parse_device(__doc__))
