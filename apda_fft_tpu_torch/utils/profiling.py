"""Profiling helpers: per-epoch metrics, device traces, spans and work counts.

Counterpart of ``apda_fft_tpu/utils/profiling.py``.  :class:`EpochMetrics`
keeps the reference's self-profile of every FFT run (process and wall time,
%CPU and peak RSS, ``GT_FFT_v5.py:623-624,663-676``); on a CUDA machine its
wall clock stops only after ``torch.cuda.synchronize()``, so it covers the
device work the epoch queued.  :func:`trace` writes a ``torch.profiler``
trace, and :func:`compiled_stats` counts a call's operations, the hand
kernels' bytes and its peak device memory.

:func:`span` marks a stage of the port on the profiler's clock.  While a
profiler runs (:func:`trace`, or any ``torch.profiler.profile``) each span
is a ``record_function`` range, so a trace shows the stages beside the
kernels they queued; otherwise a span is a shared no-op context and builds
nothing.  ``analyze_epoch`` (``models/pipeline.py``) opens these spans,
nested by time on the calling thread:

* ``apda.epoch``: one call of ``analyze_epoch`` (adaptive mode's
  prominence pass is a second, nested one);
* ``apda.place``: host arrays to the epoch's device (samples, rates,
  lengths; the rigid wipe table);
* ``apda.route``: the single-window route, with one ``apda.route.pass`` a
  kernel call and one ``apda.route.readback`` a dynamic-budget pass;
* ``apda.batched``: the batched path, with one ``apda.pass`` a pass over
  the epoch (``apda.frontend``, ``apda.detect`` and within it
  ``apda.refine``) and, under the dynamic budget, one ``apda.readback``
  after each pass.

A request whose ``apda.route`` is followed by ``apda.batched`` was handed
from the route to the batched path.  A span adds no synchronisation and
changes no result.
"""

from __future__ import annotations

import collections
import contextlib
import resource
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from apda_fft_tpu_torch.utils import kernels


#: The one context a span returns while no profiler runs.
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs, else a shared no-op context: ``with span("apda.place"): ...``.
    Untraced, it costs one check and builds nothing."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its trace into
    ``log_dir`` (Chrome trace JSON, also readable by TensorBoard's profiler
    plugin): host activity always, CUDA kernels when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


def compiled_stats(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and report ``{"flops",
    "bytes_accessed", "memory_mb"}``, the keys of the JAX package's XLA
    cost analysis.

    * ``flops``: the torch operations that ``FlopCounterMode`` counts
      (matrix products and convolutions), plus, for each hand-kernel launch,
      its kernel's float32 operations (``note_launch``, from the
      ``*_work`` function beside each wrapper);
    * ``bytes_accessed``: the hand kernels' bytes (inputs read once,
      outputs written once), or -1.0 when no kernel launched (torch
      operations' bytes are not counted);
    * ``memory_mb``: the peak of CUDA memory allocated during the call above
      what was allocated at its start, in MB, or -1.0 without a card.
    """
    launched = []
    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as counter, kernels.observe_launches(
        lambda name, nbytes, flops: launched.append((nbytes, flops))
    ):
        fn(*args, **kwargs)
    memory_mb = -1.0
    if card:
        torch.cuda.synchronize()
        memory_mb = (torch.cuda.max_memory_allocated() - start) / 1e6
    return {
        "flops": float(counter.get_total_flops() + sum(f for _, f in launched)),
        "bytes_accessed": float(sum(b for b, _ in launched)) if launched else -1.0,
        "memory_mb": memory_mb,
    }
