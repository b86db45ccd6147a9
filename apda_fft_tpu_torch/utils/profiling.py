"""Per-epoch process/wall/%CPU/RSS metrics.

Counterpart of ``apda_fft_tpu/utils/profiling.py``'s :class:`EpochMetrics`:
the reference self-profiles every FFT run with process and wall time, %CPU
and peak RSS (``GT_FFT_v5.py:623-624,663-676``), and this keeps that metric
shape.  On a CUDA machine the wall clock stops only after
``torch.cuda.synchronize()``, so it covers the device work the epoch queued.
"""

from __future__ import annotations

import collections
import contextlib
import resource
import time

import torch


class EpochMetrics:
    """Capture process/wall/%CPU/RSS around an epoch's computation.

    ``history`` is bounded: a long-running gateway measures every epoch.
    """

    def __init__(self, history_len: int = 256):
        self.last: dict[str, float] = {}
        self.history: collections.deque[dict[str, float]] = collections.deque(
            maxlen=history_len
        )

    @contextlib.contextmanager
    def measure(self):
        cpu0 = time.process_time()
        wall0 = time.perf_counter()
        try:
            yield self
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            wall = time.perf_counter() - wall0
            cpu = time.process_time() - cpu0
            self.last = {
                "process_time": cpu,
                "wall_time": wall,
                "percentage_cpu": (cpu / wall * 100.0) if wall > 0 else 0.0,
                "memrss": float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
            }
            self.history.append(self.last)
