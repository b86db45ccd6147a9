"""The port, its chip scripts and its card-side tests import neither JAX nor
the JAX package.

The machine with the card has no JAX installed, so any such import would
break the port there.  Checked in a fresh interpreter: this test process has
JAX loaded already.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import apda_fft_tpu_torch
import apda_fft_tpu_torch.models.batching
import apda_fft_tpu_torch.models.modal
import apda_fft_tpu_torch.models.pipeline
import apda_fft_tpu_torch.models.ssi
import apda_fft_tpu_torch.models.streaming
import apda_fft_tpu_torch.ops.detector_cuda
import apda_fft_tpu_torch.ops.fft_cuda
import apda_fft_tpu_torch.ops.integrate
import apda_fft_tpu_torch.ops.latency_cuda
import apda_fft_tpu_torch.ops.resample
import apda_fft_tpu_torch.ops.ringdown
import apda_fft_tpu_torch.ops.srs
import apda_fft_tpu_torch.utils.kernels
import apda_fft_tpu_torch.utils.profiling
import apda_fft_tpu_torch.utils.synthetic
import chip_smoke
import chip_profile
import tests.test_torch_gpu_card
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "apda_fft_tpu" or m.startswith("apda_fft_tpu."))
print(",".join(bad))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"JAX modules imported: {proc.stdout.strip()}"
