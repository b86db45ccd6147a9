"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: a CUDA device must be present; prints the card's name and power
   limit (``nvidia-smi``);
2. build: compiles ``apda_fft_tpu_torch/csrc/prominence_select_scan.cu``,
   ``lowlat_window.cu``, ``halfspec_fused.cu`` and ``prominence_scans.cu``
   with nvcc (sm_90a), all four at once, and prints the seconds each took;
3. kernel vs plain on the card: the select+scan kernel against its plain
   torch version on four spectrum corpora at H in {32, 128, 2048, 32768}
   and M in {2, 12, 32, 128}, at H=55000 and the longest H it keeps in
   shared memory (no room for its chunk summaries: walks bin by bin), on
   rows that stay in device memory (H in {57857, 65536, 131072}, and
   H=2**20, whose summaries go to the workspace), and on H=32768 and
   H=131072 rows with more candidates than its candidate list holds (the
   select-from-the-row route) - integers equal, floats within rtol 1e-6;
4. spectrum accuracy: the four-step magnitudes against float64 numpy.fft,
   <= 1e-6 normwise at N in {1024, 4096, 65536};
5. main path: ``analyze_epoch`` (flexible, refine, lowlat="never") on the
   B=2048 x N=4096 clean and noisy corpora, two epochs each, so the noisy
   run learns and then uses the two-tier split; the kernel's launch count
   must be > 0; every kernel call of that run is held against the plain
   version on its own spectra (at its budget and at the path's other
   budgets); decisions are checked against the port's CPU run (256
   windows) and the float64 oracle (32 windows); one rigid and one adaptive
   epoch (B=256) are checked against the CPU run; one flexible and one
   adaptive epoch at N=131072 (B=16: damped modes, and undamped tones that
   adaptive mode hands to the resolution detector; rows past the kernel's
   shared memory) against the CPU run and the oracle (4 windows);
6. times (CUDA events, warm-up, median of 20, plain-kernel-kernel-plain
   order): kernel vs plain at B=2048, H=2048, M in {2, 12, 32, 128}, and
   whole epochs in windows/s beside the front end and the detect stage
   alone; then, after all of these, the kernel's profiler device time at
   each M;
7. latency kernels vs plain on the card: ``analyze_window_lowlat`` (both
   modes, refine on) against its plain torch version on modal, noise,
   impulse and flat windows at N in {64, 1024, 4096, 16384, 32768, 65536}
   (32768 the first N whose flexible FFT buffers go to the global
   workspace) and flexible budgets {2, 8, 16, 64} - integers equal, ``mag`` within rtol
   1e-5 (one 4-dp step where rounded), ``freq`` within one 4-dp step,
   damping and q within one 2-dp step, ``refined_freq`` within 1e-3 Hz; the
   rigid kernel's integers also equal ``lowlat="never"`` and the float64
   oracle, there and on two windows past its shared room: one whose edge
   candidates outgrow their 64 slots mid-run (k=100) and one with 5000
   candidates, more than its list holds;
8. the single-window route: ``analyze_epoch(x[None], fs)`` with the default
   ``lowlat`` for cfg1 (N=1024, rigid) and cfg2 (N=4096, flexible, refine)
   and on ``tests/signals.modal_signal`` windows at (1024, 500),
   (4096, 500) and (2048, 62.5) in both modes: both latency kernels must
   launch; every kernel call of the route is held against the plain
   version; decisions equal ``lowlat="never"`` on the card and the float64
   oracle; a window needing 71 slots goes to the batched path and still
   equals ``lowlat="never"``;
9. latency times for cfg1 and cfg2: the kernel alone (device time from
   ``torch.profiler``, and CUDA events over back-to-back calls), the routed
   ``analyze_epoch``, ``lowlat="never"`` and the plain version (host wall
   clock with synchronize, median of 50), the flexible kernel at M=64 on
   the 71-candidate window and at N=65536, and the rigid kernel on
   two-tone windows at N=4096 and N=65536 (device time and call);
10. fused front end (``backend="pallas"``) vs plain on the card:
   ``fft_cuda.halfspec_magnitudes_fused`` on centred modal, noise, impulse
   and flat windows at N in {64, 1024, 4096, 16384, 32768, 65536} (16384 the
   largest N held in shared memory, 32768 and 65536 through the global
   workspace) - kernel and plain twin each <= 1e-6 normwise against float64
   numpy.fft; element by element the kernel within 2e-6 of the row maximum
   of float64 numpy.fft, and of the twin plus the twin's own error there
   (the twin, a four-step, is the less accurate side: the two differ by
   3e-6 of the row maximum on impulse windows at N = 32768); DC exactly 0;
11. the ``backend="pallas"`` path: ``analyze_epoch(..., backend="pallas",
   refine=True, lowlat="never")`` on the B=2048 x N=4096 clean and noisy
   corpora, two epochs each (the noisy one runs two-tier); the front-end
   kernel's launch count must be > 0 and every call of it is held against
   the plain twin on its own windows; decisions against the float64 oracle
   (32 windows) and the port's CPU run with ``backend="pallas"`` (256
   windows); one rigid and one adaptive epoch (B=256) against the CPU run;
   one window with ``backend="pallas"`` launches the front-end kernel and
   not the latency kernels;
12. pre-selected scans vs plain on the card: ``prominence_scans`` on the
   four spectrum corpora of phase 3 at H in {32, 2048, 32768, 65536} (the
   last in device memory) and M in
   {2, 12, 32, 128}, on the select+scan kernel's slots - integers equal,
   floats within rtol 1e-6, and the same bits as the select+scan kernel's
   prominences and widths on its valid slots; then hand-made slots on the
   same rows: peaks ``cmag = x[cid]`` times 0.5 and 2, ``cid`` in {0, 1,
   H-2, H-1, -1, H, H+7} and ``n_valid`` of -3 and M+5, against the twin;
   ``prominence_peaks_batch`` on
   the noisy corpus's spectra (B=2048) equals ``prominence_peaks_fused`` at
   the same budget, and its scans-kernel launch count must be > 0;
13. times (CUDA events, median of 20, plain-kernel-kernel-plain order): the
   front-end kernel, its plain twin and ``torch.fft.rfft``
   (``backend="xla"``) at B=2048, N=4096, with the kernel's profiler device
   time; epoch windows/s with ``backend="pallas"`` beside
   ``backend="matmul"``, interleaved, on both corpora; the scans kernel and
   its plain twin at B=2048, H=2048, M=32, and the scans kernel's call and
   profiler device time at M in {2, 12, 32, 128};

Phases 14-18 drive the record, Welch, stream, cross-spectra and pipelined
paths at the gateway's scale.  Each sets every launch count to 0 just
before it and reads them just after, taps every select+scan, latency and
front-end kernel call it makes and holds each against the plain twin on its
own inputs, and holds decisions against the port's CPU run (one intra-op
thread) and the float64 oracle:

14. records: ``analyze_records`` through a ``SpectralPipeline`` on one
   gateway epoch at ``benchmarks/scale_soak.py``'s size (256 sensors x 3
   axes x 2 rates): 768 records at fs=500 of 2500..4096 samples (the 4096
   bucket, 1024 rows with the pow2 pad), 768 at fs=1000 of 5000..8192 (the
   8192 bucket) and one 2048-sample record at 99.7 Hz (a bucket of one,
   still the batched path: no latency kernel may launch); flexible with
   refine, adaptive and rigid (the 99.7 Hz bucket takes the host
   wipe-rounding table); 64 records against the CPU run, 33 against the
   oracle; at a static budget each bucket makes at most two device-to-host
   copies (``torch.profiler`` memcpy events, one window per bucket; the
   default budgets' counts are printed); records/s;
15. Welch: ``analyze_records_welch(..., analyze=pipeline.welch)`` at the
   gateway's defaults (window 1024, hop 512, hann) on 768 records of 16384
   samples at fs=500 and 768 of 32768 at fs=1000 (31 and 63 segments a
   record), ``backend="matmul"`` and ``"pallas"``; 64 records against the
   CPU run, 32 against a float64 Welch model under the oracle detector;
   segments/s;
16. streams at BASELINE config 4 (``[64, 131072]``, N=8192):
   ``analyze_stream`` at hop 8192 (1024 windows) and 4096 (1984 windows),
   both front ends; ``spectrogram`` (``backend="pallas"``) and
   ``welch_psd`` (both) on the same records; 4 channels against the CPU
   run, 32 windows against the oracle, ``welch_psd`` within rtol 2e-2 of
   ``scipy.signal.welch``; windows/s;
17. cross spectra: ``coherence_with_phase`` and ``cross_psd`` on 32 sensor
   pairs ``[32, 131072]`` at window 4096: the shared mode coherent at
   -45 degrees in every pair; 2 pairs against the CPU run and within the
   JAX tests' tolerances of ``scipy.signal.csd`` / ``coherence``;
18. pipelined: ``analyze_epochs_pipelined`` on 16 noisy [2048, 4096]
   epochs at depth 1 and 4, and on 64 single-window epochs at depth 4 (cfg2
   windows, flexible: the flexible latency kernel; cfg1 windows, rigid: the
   rigid one); decisions equal sequential ``analyze_epoch``; every depth-4
   dispatch, and the placement of an epoch and of one window, run with
   the card's synchronisation debug mode at "error"; depth 4 against
   depth 1 in windows/s, interleaved; placing host arrays of 16 KiB to
   32 MiB on the card, pinned against pageable, also behind queued card
   work;

Phases 19-21 drive the field ops and the modal analysis at the gateway's
sizes, each against the port's CPU run (one intra-op thread) and a float64
oracle, with the host wall of one call beside its device busy time
(``torch.profiler``):

19. field ops, no kernel of the port launched: ``velocity_rms`` and
   ``integrate_acceleration`` (order 1 and 2) on the severity batches
   ``[1024, 4096]`` at 500 Hz and ``[1024, 8192]`` at 1000 Hz (256 sensors
   x 3 axes, pow2 row pad) against a float64 numpy model; ``ringdown_damping``
   and ``shock_response_spectrum`` on one 4096-sample transient at 1000 Hz
   and on 256 of them, against the true zeta and the float64
   ``scipy.signal.lfilter`` bank; ``decimate`` on one float64 record of 8192
   at q=2 and on ``[256, 8192]`` at q in {2, 4, 8}, ``resample_rational``
   100 -> 62.5 Hz, against ``scipy.signal.resample_poly`` (< 3e-6 of the
   peak: the convolution runs in IEEE float32);
20. FDD: ``fdd(records, 500, 1024, efdd=True, harmonics=True)`` on
   ``[32, 16384]`` and ``[256, 16384]`` arrays of three modes with known
   shapes: the select+scan kernel launches once a call and no other
   kernel does, every call equal to its plain twin; count/idx/freq/damping
   equal to the CPU run, shapes at MAC >= 0.99 against the known ones,
   s1/s2 against float64 ``eigh`` on the CSD; ``ModalTracker.update`` on
   the result; times of the CSD, the power iteration, the detector with its
   host copies, EFDD and the kurtosis, and the whole call;
21. SSI: ``ssi(records, 500, i=20)`` on the ``[32, 16384]`` array against
   the CPU run and the known modes; the correlation blocks one product a
   lag against one batched product over an ``unfold`` view at S = 32 and
   256 (CUDA events), the blocks' and the host identification's times;

Phase 22 drives the port's gateway, the system its users run:

22. ``GatewayService`` on the card (``tests/test_torch_gateway_parity.py``'s harness:
   fake FTP session and HTTP opener, ticking clock) over
   ``benchmarks/scale_soak.py``'s 256 sensors with the full-feature
   configuration and traffic mix of ``benchmarks/endurance.py`` (shock with
   ring-down and SRS, temperature-compensated drift, FDD window 256, SSI
   12 block rows, harmonic check, modal decimation, severity 5-100 Hz; 15 %
   of sensors skip an epoch, 250 / 125 Hz, 1000 or 2048 samples in packets
   of 200, 72 % clean / 10 % dropped / 8 % truncated / 6 % shock / 4 %
   reduced), 3 epochs with the launch counts zeroed before and read after
   and every B1 call tapped and held against its plain twin; the same
   packets through the port on the CPU (one intra-op thread) give the same
   history, ``fft_results``, uploads, API payloads and drift and modal
   state (SSI under ``tests/test_torch_ssi.py``'s rule); the native ingest
   must have loaded; per epoch packets, acquisitions, host wall, ingest
   rate, B1 launches and report lines; one more epoch under
   ``torch.profiler`` for the device busy time and idle share; then
   ``python -m apda_fft_tpu_torch.gateway --simulate --sensors 4`` on the
   card finds both modes of each sensor;

Phases 23 and 24 drive the sharded paths and the command line:

23. the mesh: ``make_mesh`` over four distinct cards where the host has
   them, else four logical shards of ``cuda:0`` (the line says which);
   ``analyze_epoch_sharded`` (flexible, refine) on the B=2048 x N=4096
   clean and noisy corpora, two epochs each (the noisy one learns and runs
   the two-tier split), rigid and adaptive at B=256 and one
   ``backend="pallas"`` epoch, with the launch counts zeroed before and
   read after: B1 launches on every shard and B4 on the pallas epoch;
   every B1/B4 call tapped and held against its plain twin; every result
   held against the single-device run on the card (``ROADMAP.md``'s "held
   against the reference" rule) and ``last_dynamic_stats()`` equal to it;
   ``distributed_halfspec_magnitudes`` on a (2, 2) grid at N=4096 (B=2048)
   and N=65536 (B=16), <= 1e-6 normwise against float64 numpy.fft;
   ``correlation_blocks_sharded`` (40 lags) and ``fdd(mesh=)`` on phase 20's
   ``[256, 16384]`` array against the single-device results;
   ``SpectralPipeline(mesh=)`` on phase 14's gateway records against the
   single-device records; ``dryrun_multichip(4)``; the sharded epoch's
   windows/s beside the single-device epoch's (CUDA events, median of 20)
   and its host wall;
24. the CLI: ``python -m apda_fft_tpu_torch <subcommand>`` in subprocesses
   (8 at a time) on generated log files, for every analysing subcommand,
   on the card (the default) and with ``--device cpu`` (one intra-op
   thread): the same exit code and output up to float32 (floats within
   1e-4 relative and one rounding step, SSI under ``tests/test_torch_ssi.py``'s
   rule); ``doctor --json`` exits 0 on the card; ``oracle-check`` prints
   MATCH for every file and mode; ``track`` raises its drift alert;

then one JSON line describing the five kernels, each with its bound (the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s, computed from the shapes timed) and the time of one PyTorch
call computing the same function where there is one, the card line, then
the result line ``{"ok": true, "device": {...}}``.

It needs one card and no network, and imports neither JAX nor the JAX
package (the oracle in ``tests/oracle.py`` is plain numpy).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import json
import os
import platform
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from apda_fft_tpu_torch.models import batching, modal, pipeline, ssi, streaming
from apda_fft_tpu_torch.ops import (
    detector_cuda,
    fft_cuda,
    integrate,
    latency_cuda,
    resample,
    ringdown,
    srs,
)
from apda_fft_tpu_torch.ops.detector_cuda import (
    _prominence_scans_plain,
    _prominence_select_scan_plain,
    prominence_peaks_batch,
    prominence_peaks_fused,
    prominence_scans,
    prominence_select_scan,
)
from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes, ieee_fp32_matmul, split_pow2
from apda_fft_tpu_torch.ops.fft_cuda import (
    _halfspec_magnitudes_fused_plain,
    halfspec_magnitudes_fused,
)
from apda_fft_tpu_torch.ops.peaks_prominence import prominence_select
from apda_fft_tpu_torch.utils import kernels
from apda_fft_tpu_torch.utils.synthetic import modal_records

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FFT = 4096
FS = 500.0
BATCH = 2048
KERNEL_SOURCE = "apda_fft_tpu_torch/csrc/prominence_select_scan.cu"
KERNEL_REPLACES = "apda_fft_tpu/ops/detector_pallas.py:360"
LOWLAT_SOURCE = "apda_fft_tpu_torch/csrc/lowlat_window.cu"
LOWLAT_REPLACES = {
    "lowlat_flexible": "apda_fft_tpu/ops/latency_pallas.py:467",
    "lowlat_rigid": "apda_fft_tpu/ops/latency_pallas.py:448",
}
HALFSPEC_SOURCE = "apda_fft_tpu_torch/csrc/halfspec_fused.cu"
HALFSPEC_REPLACES = "apda_fft_tpu/ops/fft_pallas.py:115"
SCANS_SOURCE = "apda_fft_tpu_torch/csrc/prominence_scans.cu"
SCANS_REPLACES = "apda_fft_tpu/ops/detector_pallas.py:116"
TIMING_RUNS = 20
WALL_RUNS = 50
#: H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and float32
#: FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: Longest row the select+scan kernel keeps in shared memory (its
#: kSharedMaxH): 227 KB less 1 KB of static scratch, in floats.
B1_SHARED_MAX_H = (227 * 1024 - 1024) // 4
#: Window length of the long-row epochs of phase 5.
N_LONG = 131072


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- corpora


def clean_batch(batch: int, n: int = N_FFT) -> np.ndarray:
    """bench.py's clean epoch: two tones + DC + light noise, seed 42 (one
    such window is the BASELINE configurations' window)."""
    rng = np.random.default_rng(42)
    t = np.arange(n) / FS
    base = np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t) + 0.1
    return (base[None, :] + 0.05 * rng.standard_normal((batch, n))).astype(np.float32)


def noisy_batch(batch: int) -> np.ndarray:
    """bench.py's noisy epoch: unit broadband noise + 4 weak damped modes, seed 1234."""
    rng = np.random.default_rng(1234)
    t = np.arange(N_FFT) / FS
    x = rng.standard_normal((batch, N_FFT)).astype(np.float64)
    for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008),
                       (88.4, 0.55, 0.015), (141.2, 0.45, 0.02)):
        phase = rng.uniform(0, 2 * np.pi, size=(batch, 1))
        x += a * np.sin(2 * np.pi * f * t[None, :] + phase) * np.exp(
            -zeta * 2 * np.pi * f * t[None, :]
        )
    return x.astype(np.float32)


def spectra(b: int, h: int, seed: int, kind: str) -> np.ndarray:
    """Half-spectrum magnitudes with a zeroed DC bin: modal, noise, flat or
    ties (quantized so rounded-magnitude ties are everywhere)."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "modal":
        x = np.zeros((b, h))
        for w in range(b):
            for _ in range(rng.integers(1, 5)):
                c = rng.uniform(4, h - 4)
                width = rng.uniform(0.8, 6.0)
                amp = rng.uniform(1.0, 40.0)
                x[w] += amp * np.exp(-0.5 * ((bins - c) / width) ** 2)
        x += rng.uniform(0.0, 0.3) * rng.random((b, h))
    elif kind == "noise":
        x = rng.random((b, h)) * 5.0
    elif kind == "flat":
        x = np.full((b, h), 2.5)
    else:
        x = np.round(rng.random((b, h)) * 30.0) / 10.0
    x[:, 0] = 0.0
    return x.astype(np.float32)


def centered_mags(x: torch.Tensor) -> torch.Tensor:
    return halfspec_magnitudes(x - x.mean(dim=-1, keepdim=True), backend="matmul")


# ---------------------------------------------------------------- timing


def event_ms(fn, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}; "
        f"host {platform.machine()}, {torch.get_num_threads()} torch threads")
    log(card)
    return card


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the
    larger of ``nbytes`` (each input read once, each output written once)
    over the HBM rate and ``flops`` float32 operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def rfft_mag_flops(n: int) -> int:
    """Float32 operations that |rfft| of one real ``n``-point window needs,
    whatever the algorithm: 2.5*n*log2(n) for the real FFT (half of a
    complex radix-2 FFT's 5*n*log2(n)), then two multiplies, an add and a
    square root for each of the n/2 magnitudes.  The four-step that the
    kernels run does more (2*n*n1 + 4*(n/2)*n2 FMAs); a bound counts only
    what the function needs."""
    return int(2.5 * n * (n.bit_length() - 1)) + 4 * (n // 2)


def phase_build() -> None:
    """Builds the four sources at once, one nvcc each."""
    def build(name, load):
        t0 = time.perf_counter()
        load()
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(build, "prominence_select_scan", detector_cuda._kernel_fn),
                   pool.submit(build, "lowlat_window", latency_cuda._kernel_fn),
                   pool.submit(build, "halfspec_fused", fft_cuda._kernel_fn),
                   pool.submit(build, "prominence_scans", detector_cuda._scans_kernel_fn)]
        for fut in futures:
            name, sec = fut.result()
            log(f"[2 build] {os.path.relpath(kernels.library_path(name), ROOT)} in "
                f"{sec:.2f} s")
    log(f"[2 build] all four in {time.perf_counter() - t0:.2f} s (nvcc {kernels.nvcc_path()})")


def _kernel_equals_plain(mags: torch.Tensor, m: int, got, case: str) -> float:
    """Hold the kernel's seven outputs ``got`` for ``mags`` at budget ``m``
    against the plain version: integers equal, floats within rtol 1e-6.
    Returns the max abs float difference."""
    want = _prominence_select_scan_plain(mags, min(m, mags.shape[-1]))
    names = ("cid", "is_cand", "cmag", "prom", "bins", "std", "n_cand")
    err = 0.0
    for name, g, w in zip(names, got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.shape == w.shape, (case, name, g.shape, w.shape)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{case} {name}")
            err = max(err, float(np.abs(g - w).max(initial=0.0)))
    return err


def overflow_spectra(b: int, h: int = 32768) -> np.ndarray:
    """Rows with 5000 strict maxima above the threshold, more than the
    select+scan kernel's candidate list holds (4096 keys): odd bins 1..9999
    at 6 or 7 (2232 and 2768 of them, shuffled per row, so rounded scores
    tie everywhere), zero elsewhere.  The sum is 32768, so at h = 32768 or
    131072 the mean (1 or 1/4) and every squared deviation are multiples of
    1/16 whose sums fit in float32's 24 bits: the threshold's sums are exact
    in any order and the kernel's std must equal the plain version's."""
    rng = np.random.default_rng(h)
    x = np.zeros((b, h), np.float32)
    levels = np.array([6.0] * 2232 + [7.0] * 2768, np.float32)
    for row in x:
        row[1:10000:2] = rng.permutation(levels)
    return x


def phase_kernel_vs_plain() -> float:
    """Kernel against plain torch on the card; returns the max abs float error."""
    before = detector_cuda.launches
    worst = 0.0
    for kind in ("modal", "noise", "flat", "ties"):
        for h in (32, 128, 2048, 32768):
            b = 16 if h > 4096 else 64
            mags = torch.from_numpy(spectra(b, h, seed=h + len(kind), kind=kind)).cuda()
            diffs = []
            for m in (2, 12, 32, 128):
                got = prominence_select_scan(mags, m)
                err = _kernel_equals_plain(mags, m, got, f"{kind} H={h} M={m}")
                diffs.append(err)
                worst = max(worst, err)
            log(f"[3 kernel==plain] {kind:5s} H={h:5d} B={b}: max|float diff| at "
                f"M=2/12/32/128 = {', '.join(f'{d:.3g}' for d in diffs)}")
    cases = 64
    # Long rows.  In shared memory, no room for the chunk summaries, so the
    # walks go bin by bin: at H=55000 on the candidate list, at the longest
    # row kept there (no room for a list either) on the select-from-the-row
    # route.  Past it the row stays in device memory, its summaries and list
    # in shared memory; at H=2**20 the summaries go to the workspace.
    for h, budgets, where in ((55000, (2, 12, 32, 128), "shared, no chunk summaries"),
                              (B1_SHARED_MAX_H, (2, 12, 32, 128), "shared, no list"),
                              (B1_SHARED_MAX_H + 1, (2, 12, 32, 128), "device memory"),
                              (65536, (2, 12, 32, 128), "device memory"),
                              (131072, (2, 12, 32, 128), "device memory"),
                              (1 << 20, (2, 12), "device memory, summaries in the workspace")):
        mags = torch.from_numpy(spectra(2, h, seed=5, kind="modal")).cuda()
        diffs = [_kernel_equals_plain(mags, m, prominence_select_scan(mags, m),
                                      f"modal H={h} M={m}") for m in budgets]
        worst = max(worst, *diffs)
        cases += len(budgets)
        log(f"[3 kernel==plain] modal H={h} B=2 ({where}): max|float diff| at "
            f"M={'/'.join(map(str, budgets))} = {', '.join(f'{d:.3g}' for d in diffs)}")
    for h in (32768, 131072):
        mags = torch.from_numpy(overflow_spectra(4, h)).cuda()
        diffs = []
        for m in (2, 12, 32, 128):
            got = prominence_select_scan(mags, m)
            assert int(got[6].min()) > 4096, got[6].tolist()  # past the candidate list
            diffs.append(_kernel_equals_plain(mags, m, got, f"overflow H={h} M={m}"))
        worst = max(worst, *diffs)
        cases += 4
        log(f"[3 kernel==plain] overflow H={h} B=4 (n_cand {got[6].tolist()}): max|float "
            f"diff| at M=2/12/32/128 = {', '.join(f'{d:.3g}' for d in diffs)}")
    assert detector_cuda.launches > before, "the kernel was never launched"
    log(f"[3 kernel==plain] all {cases} cases equal; launches {detector_cuda.launches - before}; "
        f"max abs float diff {worst:.3g}")
    return worst


def phase_spectrum() -> None:
    rng = np.random.default_rng(7)
    for n, b in ((1024, 64), (4096, 64), (65536, 8)):
        x = rng.standard_normal((b, n)).astype(np.float32)
        ref = np.abs(np.fft.rfft(x.astype(np.float64))[:, : n // 2])
        ref[:, 0] = 0.0
        got = halfspec_magnitudes(torch.from_numpy(x).cuda(), backend="matmul").cpu().numpy()
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        log(f"[4 spectrum] N={n}: normwise error vs float64 numpy.fft {err:.3e}")
        assert err <= 1e-6, (n, err)


def _assert_same(got, want, fields_exact, fields_close, where: str) -> None:
    for f in fields_exact:
        np.testing.assert_array_equal(
            getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy(),
            err_msg=f"{where} {f}")
    for f, atol, rtol in fields_close:
        np.testing.assert_allclose(
            getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy(),
            atol=atol, rtol=rtol, err_msg=f"{where} {f}")


def _which_side(x, gpu, cpu, oracle, backend: str = "matmul") -> str:
    """For a card-vs-CPU mismatch: the first differing window's magnitudes
    on both sides and in the float64 oracle, and both front ends' errors."""
    d = (gpu.mag.cpu() - cpu.mag).abs().amax(-1)
    i = int(torch.argmax(d))
    want = [p["mag"] for p in oracle.oracle_analyze(x[i].astype(np.float64), FS, "flexible")]
    w = x[i : i + 1] - x[i : i + 1].mean(axis=-1, keepdims=True)
    ref = np.abs(np.fft.rfft(w.astype(np.float64))[:, : N_FFT // 2])
    ref[:, 0] = 0.0
    errs = []
    for dev in ("cpu", "cuda"):
        got = halfspec_magnitudes(torch.from_numpy(w).to(dev), backend=backend).cpu().numpy()
        errs.append(f"{dev} {np.linalg.norm(got - ref) / np.linalg.norm(ref):.3e}")
    return (f"window {i} ({int((d > 1e-3).sum())} differ): card mag {gpu.mag[i].tolist()}, "
            f"CPU mag {cpu.mag[i].tolist()}, oracle {want}; front end normwise "
            f"error now: {', '.join(errs)}")


def _cpu_reference(*args, **kwargs):
    """The port's own ``analyze_epoch`` on the host, on one intra-op thread.

    On the H100 machine's host, 8-thread CPU runs now and then returned the
    magnitudes of exactly one thread's 32-window block about 2e-4 off (the
    card and the float64 oracle agreed with each other).  The port's CPU
    transforms run on one thread since (``ops.fft._one_cpu_thread``); the
    cause is not localized, so this reference keeps the rest of the epoch on
    one thread too.  ``chip_profile.py --cpu-probe`` probes the fault there,
    and ``tests/test_torch_fft.py`` checks the guard wherever the tests run.
    """
    with _one_cpu_thread():
        return pipeline.analyze_epoch(*args, **kwargs)


@contextlib.contextmanager
def _one_cpu_thread():
    """One intra-op thread for a CPU reference run (see ``_cpu_reference``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _load_module(name: str, filename: str):
    """A plain-numpy helper of ``tests/`` loaded by path (``tests`` is not a
    package the port depends on)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tests", filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_oracle():
    return _load_module("apda_oracle", "oracle.py")


def phase_main_path_kernel_calls(calls) -> float:
    """Every kernel call of the main path against the plain version on the
    same spectra: at the call's own budget (the outputs the main path got),
    then at the path's other budgets.  Returns the max abs float error."""
    budgets = (2, 12, 32, 128)
    worst = 0.0
    for i, (mags, m, got) in enumerate(calls):
        shape = "x".join(map(str, mags.shape))
        diffs = [_kernel_equals_plain(mags, m, got, f"main-path call {i} [{shape}] M={m}")]
        for other in budgets:
            if other != m:
                case = f"main-path call {i} [{shape}] at M={other}"
                diffs.append(_kernel_equals_plain(
                    mags, other, prominence_select_scan(mags, other), case))
        worst = max(worst, *diffs)
        log(f"[5 kernel==plain] main-path call {i}: [{shape}] M={m}: equal; max|float "
            f"diff| {diffs[0]:.3g}; also equal at M in "
            f"{[o for o in budgets if o != m]} (max {max(diffs[1:]):.3g})")
    return worst


def long_batch() -> np.ndarray:
    """Phase 5's N=131072 epoch (B=16): twelve windows of four lightly
    damped modes near 10, 18, 30 and 45 Hz (``tests/signals.py``
    ``modal_signal``, seeds 0..11; the prominence detector accepts all four
    within its first ~20 candidates), then four of two undamped tones on
    exact bins (3000 and 11000), whose one-bin peaks fail its damping floor,
    so adaptive mode hands them to the resolution detector."""
    signals = _load_module("apda_signals", "signals.py")
    rows = []
    for seed in range(12):
        rng = np.random.default_rng(seed)
        modes = [(f * rng.uniform(0.96, 1.04), rng.uniform(1.0, 2.0), rng.uniform(0.002, 0.004))
                 for f in (10.0, 18.0, 30.0, 45.0)]
        rows.append(signals.modal_signal(N_LONG, FS, modes=modes, noise=0.01, seed=seed))
    t = np.arange(N_LONG) / FS
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        phase = rng.uniform(0, 2 * np.pi, 2)
        rows.append(np.sin(2 * np.pi * (3000 * FS / N_LONG) * t + phase[0])
                    + 0.6 * np.sin(2 * np.pi * (11000 * FS / N_LONG) * t + phase[1])
                    + 0.05 * rng.standard_normal(N_LONG) + 0.1)
    return np.stack(rows).astype(np.float32)


def phase_main_path(corpora: dict[str, np.ndarray]) -> tuple[int, float]:
    """Drive analyze_epoch on the card; returns the kernel launches it made
    and the max abs float error of its kernel calls against plain."""
    pipeline.reset_dynamic_state()
    results, budgets = {}, {}
    # Tap the wrapper the pipeline calls, so that each kernel call of the
    # main path can be held against the plain version on its own spectra.
    calls = []
    wrapper = detector_cuda.prominence_select_scan

    def tapped(mags, max_candidates):
        out = wrapper(mags, max_candidates)
        calls.append((mags.clone(), max_candidates, tuple(o.clone() for o in out)))
        return out

    detector_cuda.prominence_select_scan = tapped
    detector_cuda.launches = 0
    for name, x in corpora.items():
        xs = torch.from_numpy(x).cuda()
        for epoch in range(2):
            res = pipeline.analyze_epoch(
                xs, FS, n_fft=N_FFT, mode="flexible", refine=True, lowlat="never"
            )
            torch.cuda.synchronize()
            stats = dict(pipeline.last_dynamic_stats())
            log(f"[5 main path] {name} epoch {epoch}: count>0 in "
                f"{int((res.count > 0).sum())}/{x.shape[0]} windows; {stats}")
        results[name], budgets[name] = res, stats
    # Rows past the kernel's shared memory: N=131072.
    long_x = long_batch()
    long_res = {}
    before_long = detector_cuda.launches
    for mode in ("flexible", "adaptive"):
        res = pipeline.analyze_epoch(torch.from_numpy(long_x).cuda(), FS, n_fft=N_LONG,
                                     mode=mode, refine=True, lowlat="never")
        torch.cuda.synchronize()
        long_res[mode] = (res, dict(pipeline.last_dynamic_stats()))
        log(f"[5 main path] N={N_LONG} {mode} B={long_x.shape[0]}: counts "
            f"{res.count.tolist()}; {long_res[mode][1]}")
    long_launches = detector_cuda.launches - before_long
    launches = detector_cuda.launches
    detector_cuda.prominence_select_scan = wrapper
    log(f"[5 main path] dynamic_state {pipeline.dynamic_state()}")
    log(f"[5 main path] kernel launches on the main path: {launches} "
        f"(calls at {[(tuple(c[0].shape), c[1]) for c in calls]})")
    assert launches > 0, "the main path never launched the detector kernel"
    assert long_launches > 0, f"the N={N_LONG} epochs never launched the detector kernel"
    assert launches == len(calls), (launches, len(calls))
    assert budgets["noisy"]["tier"] is not None, "the noisy epoch did not run two-tier"
    max_err = phase_main_path_kernel_calls(calls)
    del calls

    oracle = _load_oracle()
    for name, x in corpora.items():
        res = results[name]
        assert res.freq.shape == (x.shape[0], 4) and bool(torch.isfinite(res.freq).all())
        for i in range(32):
            want = oracle.oracle_analyze(x[i].astype(np.float64), FS, "flexible")
            c = int(res.count[i])
            assert c == len(want), (name, i, c, len(want))
            assert res.idx[i, :c].tolist() == [p["idx"] for p in want], (name, i)
            np.testing.assert_allclose(res.freq[i, :c].cpu().numpy(),
                                       [p["freq"] for p in want], atol=1e-4, rtol=1e-6)
        # The CPU reference runs on its own copy of the windows, at the
        # budget the card's last pass used.
        xc = torch.tensor(x[:256])
        cpu = _cpu_reference(
            xc, FS, n_fft=N_FFT, mode="flexible", refine=True, lowlat="never",
            max_candidates=budgets[name]["candidate_budget"],
        )
        gpu = type(res)(*(f[:256] for f in res))
        try:
            _assert_same(gpu, cpu, ("count", "idx", "n_candidates", "n_required"),
                         (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-6)), f"{name} vs CPU")
        except AssertionError as err:
            raise AssertionError(f"{err}\n{_which_side(x, gpu, cpu, oracle)}") from err
        log(f"[5 main path] {name}: 32 windows equal to the float64 oracle, 256 windows "
            f"equal to the CPU run at budget {budgets[name]['candidate_budget']}")

    for mode, name in (("rigid", "clean"), ("adaptive", "noisy")):
        x = corpora[name][:256]
        gpu = pipeline.analyze_epoch(torch.from_numpy(x).cuda(), FS, n_fft=N_FFT, mode=mode)
        cpu = _cpu_reference(torch.tensor(x), FS, n_fft=N_FFT, mode=mode)
        _assert_same(gpu, cpu, ("count", "idx"),
                     (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-5)), f"{mode} vs CPU")
        log(f"[5 main path] {mode} B=256 ({name}): decisions equal to the CPU run; "
            f"count>0 in {int((gpu.count > 0).sum())} windows")
    for mode, (gpu, stats) in long_res.items():
        cpu = _cpu_reference(torch.tensor(long_x), FS, n_fft=N_LONG, mode=mode, refine=True,
                             lowlat="never", max_candidates=stats["candidate_budget"])
        _assert_same(gpu, cpu, ("count", "idx", "n_candidates", "n_required"),
                     (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-5)), f"N={N_LONG} {mode} vs CPU")
        for i in (0, 1, 12, 13):
            want = oracle.oracle_analyze(long_x[i].astype(np.float64), FS, mode)
            c = int(gpu.count[i])
            assert gpu.idx[i, :c].tolist() == [p["idx"] for p in want], (mode, i)
        assert bool((gpu.count[12:] > 0).all()) == (mode == "adaptive"), gpu.count.tolist()
        log(f"[5 main path] N={N_LONG} {mode}: {long_x.shape[0]} windows equal to the CPU run "
            f"at budget {stats['candidate_budget']}, windows 0, 1, 12, 13 to the float64 "
            f"oracle; kernel launches {long_launches} for both epochs")
    return launches, max_err


def phase_times(corpora: dict[str, np.ndarray], card: str) -> tuple[float, float]:
    """Returns (kernel ms, plain ms) at H=2048, M=12.  The CUDA-event times
    and the epochs come before any profiler session, so that no profiler
    has yet run in the process when they are taken."""
    mags = centered_mags(torch.from_numpy(corpora["noisy"]).cuda()).contiguous()
    n_cand = float(prominence_select_scan(mags, 1)[6].float().mean())
    budgets = (2, 12, 32, 128)
    times = {}
    for m in budgets:
        p_ms = event_ms(lambda: _prominence_select_scan_plain(mags, m))
        k_ms = event_ms(lambda: prominence_select_scan(mags, m))
        k2_ms = event_ms(lambda: prominence_select_scan(mags, m))
        p2_ms = event_ms(lambda: _prominence_select_scan_plain(mags, m))
        times[m] = (k_ms, k2_ms, p_ms, p2_ms)
    for name, x in corpora.items():
        xs = torch.from_numpy(x).cuda()
        ms = event_ms(lambda: pipeline.analyze_epoch(
            xs, FS, n_fft=N_FFT, mode="flexible", refine=True, lowlat="never"))
        mc = pipeline.steady_state_max_candidates(N_FFT, "flexible", BATCH)
        fe_ms = event_ms(lambda: centered_mags(xs))
        spec = centered_mags(xs)
        det_ms = event_ms(lambda: pipeline.detect_from_mags(spec, FS, n_fft=N_FFT))
        log(f"[6 times] epoch {name} B={BATCH} N={N_FFT}: {ms:.4f} ms = "
            f"{BATCH / (ms / 1e3):.1f} windows/s (budget {mc}; front end alone "
            f"{fe_ms:.4f} ms, detect+refine alone {det_ms:.4f} ms; median of "
            f"{TIMING_RUNS}; {card})")
    for m in budgets:
        dev_ms = _kernel_device_ms(lambda: prominence_select_scan(mags, m), "select_scan_kernel")
        k_ms, k2_ms, p_ms, p2_ms = times[m]
        log(f"[6 times] select+scan B={BATCH} H={N_FFT // 2} M={m} (noisy spectra, mean "
            f"n_cand {n_cand:.2f}): kernel {k_ms:.4f} / {k2_ms:.4f} ms (device {dev_ms:.4f} ms, "
            f"profiler mean of 20, taken last), plain torch {p_ms:.4f} / {p2_ms:.4f} ms "
            f"(median of {TIMING_RUNS}, plain-kernel-kernel-plain order; {card})")
    k_ms, k2_ms, p_ms, p2_ms = times[12]
    return min(k_ms, k2_ms), min(p_ms, p2_ms)


# ---------------------------------------------------------------- latency route


#: 32768 is the first N whose flexible FFT buffers go to the workspace.
LOWLAT_NS = (64, 1024, 4096, 16384, 32768, 65536)
LOWLAT_BUDGETS = (2, 8, 16, 64)


def lowlat_window(n: int, kind: str, seed: int = 7) -> np.ndarray:
    """One window: modal (two tones + noise + offset), noise, impulse
    (8 sparse spikes) or flat (a constant: no candidates)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    if kind == "modal":
        x = (np.sin(2 * np.pi * 0.025 * FS * t) + 0.6 * np.sin(2 * np.pi * 0.095 * FS * t)
             + 0.05 * rng.standard_normal(n) + 3.0)
    elif kind == "noise":
        x = rng.standard_normal(n)
    elif kind == "impulse":
        x = np.zeros(n)
        x[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    else:
        x = np.full(n, 2.5)
    return x.astype(np.float32)


def overflow_window(n: int = 4096) -> np.ndarray:
    """71 bin-exact tones above bin 1000: every candidate fails the damping
    floor, so the walk never completes and needs all 71 slots."""
    t = np.arange(n) / FS
    return sum(np.sin(2 * np.pi * (b * FS / n) * t)
               for b in range(1100, 1313, 3)).astype(np.float32)


def rigid_edge_window(n: int = 16384) -> np.ndarray:
    """A window whose rigid greedy outgrows the kernel's 64 edge slots.  Its
    spectrum: at bins j = 40, ... up to 8 % of the half spectrum, a spike
    on a ramp down to its two ends at nd + 1 bins each side, nd =
    round(0.02*j) the greedy's wipe count; zero elsewhere; random phases.
    Spikes (1.3 up) and ends (1.0 up) rise 0.002 a cluster and the right
    end is 0.001 above the left, so no two local maxima tie.  Each spike's
    wipe empties its ramp but for its two ends, which become local maxima
    above the threshold; the spikes are taken first, so after 33 of them
    more than 64 such bins wait and the kernel selects from the row
    (``tests/test_torch_rigid_plan.py`` holds its model to that)."""
    h = n // 2
    rng = np.random.default_rng(n)
    mags = np.zeros(h + 1)
    j, i = 40, 0
    while j < 0.08 * h:
        nd = int(np.round(0.02 * j))
        top = 1.3 + 0.002 * i
        mags[j - nd - 1:j + 1] = np.linspace(1.0 + 0.002 * i, top, nd + 2)
        mags[j:j + nd + 2] = np.linspace(top, 1.001 + 0.002 * i, nd + 2)
        j, i = j + 2 * nd + 5, i + 1
    spec = mags * np.exp(2j * np.pi * rng.random(h + 1))
    spec[0] = 0.0
    spec[h] = spec[h].real
    return np.fft.irfft(spec, n).astype(np.float32)


def rigid_list_window(n: int = 65536) -> np.ndarray:
    """A window with 5000 strict maxima above the threshold, more than the
    single-window kernels' candidate list holds (4096 keys): tones on the odd
    bins 1..9999 at magnitudes 6, 6.0001, ..., 6.4999 in shuffled order (no
    two tie; random phases), so the rigid kernel selects every round's peak
    from the row."""
    rng = np.random.default_rng(n)
    spec = np.zeros(n // 2 + 1, complex)
    odd = np.arange(1, 10000, 2)
    levels = 6.0 + 1e-4 * rng.permutation(odd.size)
    spec[odd] = levels * np.exp(2j * np.pi * rng.random(odd.size))
    return np.fft.irfft(spec, n).astype(np.float32)


def _lowlat_plain(x, fs, mode, k, budget, refine):
    return latency_cuda._analyze_window_lowlat_plain(
        x, fs, n_fft=x.shape[-1], mode=mode, k=k, budget=min(budget, x.shape[-1] // 2),
        refine=refine)


def _lowlat_equals_plain(got, want, mode: str, case: str) -> float:
    """Integers equal; ``mag`` within rtol 1e-5 (the kernel's front end sums
    in another order than ``torch.matmul``) plus one 4-dp step where it is
    rounded (flexible); ``freq`` within one 4-dp step, damping and q within
    one 2-dp step; ``refined_freq`` within 1e-3 Hz; prominence within
    1e-5 of the largest magnitude.  Returns the max abs float difference."""
    g = {f: getattr(got, f).cpu().numpy() for f in got._fields}
    w = {f: getattr(want, f).cpu().numpy() for f in want._fields}
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f"{case} {f}")
    rounded = mode == "flexible"
    scale = max(1.0, float(np.abs(w["mag"]).max(initial=0.0)))
    tol = {"mag": (1e-4 if rounded else 0.0, 1e-5), "freq": (1e-4, 1e-6),
           "damping": (1e-2, 0.0), "q_factor": (1e-2, 0.0),
           "refined_freq": (1e-3, 0.0), "prominence": (1e-5 * scale, 1e-5)}
    err = 0.0
    for f, (atol, rtol) in tol.items():
        np.testing.assert_allclose(g[f], w[f], atol=atol, rtol=rtol, err_msg=f"{case} {f}")
        err = max(err, float(np.abs(g[f] - w[f]).max(initial=0.0)))
    return err


def phase_lowlat_vs_plain() -> dict[str, float]:
    """Both latency kernels against their plain version on the card; returns
    the max abs float difference per kernel."""
    fs = torch.tensor(FS, device="cuda")
    oracle = _load_oracle()
    worst = {"lowlat_flexible": 0.0, "lowlat_rigid": 0.0}
    cases = 0
    for n in LOWLAT_NS:
        for kind in ("modal", "noise", "impulse", "flat"):
            x = torch.from_numpy(lowlat_window(n, kind)).cuda()
            line = []
            for mode, budgets in (("rigid", (2,)), ("flexible", LOWLAT_BUDGETS)):
                for m in budgets:
                    got = latency_cuda.analyze_window_lowlat(
                        x, fs, mode=mode, max_candidates=m, refine=True)
                    want = _lowlat_plain(x, fs, mode, got.k, m, True)
                    err = _lowlat_equals_plain(got, want, mode, f"{kind} N={n} {mode} M={m}")
                    if mode == "rigid":
                        # Rigid decisions compare raw magnitudes: also against
                        # the batched path and the float64 oracle.
                        never = pipeline.analyze_epoch(x[None], FS, n_fft=n, mode="rigid",
                                                       refine=True, lowlat="never")
                        _assert_same(got, never, ("count", "idx", "n_candidates"), (),
                                     f"{kind} N={n} rigid vs lowlat=never")
                        ref = oracle.oracle_analyze(x.cpu().numpy().astype(np.float64), FS,
                                                    "rigid")
                        c = int(got.count[0])
                        assert got.idx[0, :c].tolist() == [p["idx"] for p in ref], (kind, n)
                    key = f"lowlat_{mode}"
                    worst[key] = max(worst[key], err)
                    line.append(f"{mode[0]}{m if mode == 'flexible' else ''}:"
                                f"{int(got.count[0])}/{int(got.n_candidates[0])}")
                    cases += 1
            log(f"[7 lowlat==plain] {kind:7s} N={n:5d}: equal (count/n_cand {' '.join(line)}); "
                f"rigid also equal to lowlat=never and the float64 oracle")
    # The rigid kernel's routes past its shared room: the edge set outgrown
    # mid-run (66 acceptances, past the 64 it keeps in shared memory), and a
    # candidate list outgrown from the start.
    for name, xn, k in (("edge-set overflow", rigid_edge_window(), 100),
                        ("list overflow", rigid_list_window(), 5)):
        n = xn.shape[-1]
        x = torch.from_numpy(xn).cuda()
        got = latency_cuda.analyze_window_lowlat(x, fs, mode="rigid", k=k, refine=True)
        want = _lowlat_plain(x, fs, "rigid", k, 2, True)
        worst["lowlat_rigid"] = max(worst["lowlat_rigid"], _lowlat_equals_plain(
            got, want, "rigid", f"{name} N={n} rigid"))
        never = pipeline.analyze_epoch(x[None], FS, n_fft=n, mode="rigid", k=k, refine=True,
                                       lowlat="never")
        _assert_same(got, never, ("count", "idx", "n_candidates"), (),
                     f"{name} N={n} rigid vs lowlat=never")
        ref = oracle.oracle_resolution_peaks(oracle.oracle_spectrum(xn.astype(np.float64)), FS,
                                             k=k)
        c = int(got.count[0])
        assert got.idx[0, :c].tolist() == [p["idx"] for p in ref], name
        cases += 1
        log(f"[7 lowlat==plain] rigid {name} N={n} k={k}: count {c}, n_cand "
            f"{int(got.n_candidates[0])}; equal to the plain version, lowlat=never and the "
            f"float64 oracle")
    log(f"[7 lowlat==plain] all {cases} cases equal; launches {latency_cuda.launches}; "
        f"max abs float diff {worst}")
    return worst


def phase_route(oracle, signals) -> tuple[dict[str, int], float]:
    """The single-window route through ``analyze_epoch`` on the card.
    Returns the latency kernels' launches in it and the max abs float
    difference of its kernel calls against the plain version."""
    calls = []
    wrapper = latency_cuda.analyze_window_lowlat

    def tapped(x, fs, **kw):
        out = wrapper(x, fs, **kw)
        calls.append((x.clone(), fs.clone(), kw, type(out)(*(o.clone() for o in out))))
        return out

    def route(x, mode, refine, fs=FS):
        xs = torch.from_numpy(x[None]).cuda()
        got = pipeline.analyze_epoch(xs, fs, n_fft=x.shape[-1], mode=mode, refine=refine)
        never = pipeline.analyze_epoch(xs, fs, n_fft=x.shape[-1], mode=mode, refine=refine,
                                       lowlat="never")
        _assert_same(got, never, ("count", "idx", "n_candidates", "n_required"),
                     (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-5), ("damping", 1e-2, 0),
                      ("q_factor", 1e-2, 0), ("refined_freq", 1e-3, 0)),
                     f"route N={x.shape[-1]} {mode} vs lowlat=never")
        return got

    pipeline.reset_dynamic_state()
    latency_cuda.analyze_window_lowlat = tapped
    for key in latency_cuda.launches:
        latency_cuda.launches[key] = 0
    try:
        for name, n, mode, refine in (("cfg1", 1024, "rigid", False),
                                      ("cfg2", 4096, "flexible", True)):
            before = dict(latency_cuda.launches)
            res = route(clean_batch(1, n)[0], mode, refine)
            launched = latency_cuda.launches[f"lowlat_{mode}"] - before[f"lowlat_{mode}"]
            assert launched > 0, f"{name} did not go through the {mode} latency kernel"
            log(f"[8 route] {name} N={n} {mode}: {launched} launch(es); idx "
                f"{res.idx[0].tolist()}, freq {res.freq[0].tolist()}; equal to lowlat=never")
        for n, fs, seed in ((1024, 500.0, 0), (4096, 500.0, 3), (2048, 62.5, 6)):
            x = signals.modal_signal(n, fs, seed=seed).astype(np.float32)
            for mode in ("rigid", "flexible"):
                before = sum(latency_cuda.launches.values())
                res = route(x, mode, True, fs)
                want = oracle.oracle_analyze(x.astype(np.float64), fs, mode)
                c = int(res.count[0])
                assert res.idx[0, :c].tolist() == [p["idx"] for p in want], (n, fs, mode)
                np.testing.assert_allclose(res.freq[0, :c].cpu().numpy(),
                                           [p["freq"] for p in want], atol=1e-4, rtol=1e-6)
                assert sum(latency_cuda.launches.values()) > before, (n, fs, mode)
                log(f"[8 route] modal_signal N={n} fs={fs} {mode}: idx "
                    f"{res.idx[0, :c].tolist()} equal to the float64 oracle and lowlat=never")
        before = latency_cuda.launches["lowlat_flexible"]
        route(overflow_window(), "flexible", True)
        launches = dict(latency_cuda.launches)
        budget = pipeline.dynamic_state()["budget"][(4096, "flexible")]
        assert launches["lowlat_flexible"] > before
        assert budget > pipeline.LOWLAT_MAX_BUDGET, budget
        log(f"[8 route] 71-slot window: the kernel reported it, the batched path re-ran it "
            f"(budget {budget}); equal to lowlat=never")
    finally:
        latency_cuda.analyze_window_lowlat = wrapper
        pipeline.reset_dynamic_state()
    log(f"[8 route] latency kernel launches on the route: {launches}")
    assert all(v > 0 for v in launches.values()), launches

    worst = 0.0
    for x, fs, kw, got in calls:
        mode = kw["mode"]
        want = _lowlat_plain(x, fs, mode, kw["k"], kw["max_candidates"], kw["refine"])
        worst = max(worst, _lowlat_equals_plain(
            got, want, mode, f"route call N={x.shape[-1]} {mode} M={kw['max_candidates']}"))
    log(f"[8 route] all {len(calls)} kernel calls of the route equal the plain version; "
        f"max abs float diff {worst:.3g}")
    return launches, worst


def _wall_ms(fn, runs: int = WALL_RUNS, warmup: int = 3) -> float:
    """Median host wall time of ``fn()`` followed by a synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_device_ms(fn, name: str, runs: int = 20) -> float:
    """Mean device time per launch of the CUDA kernel whose name holds
    ``name``, from ``torch.profiler`` over the last ``runs`` of ``runs + 1``
    calls of ``fn``.  On the H100 machine a session at times records fewer
    kernel events than were launched (19 of 20, the same in three sessions
    in a row; once 2 of 20): the extra call heads the session, and a session
    with fewer than ``runs`` events is discarded and taken again, at most
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs + 1):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and name in e.name),
                        key=lambda e: e.time_range.start)
        if len(events) >= runs:
            break
        log(f"[profiler] {name}: {len(events)} of {runs + 1} kernel events recorded; "
            f"session {attempt + 1} of 3 discarded")
    assert len(events) >= runs, (name, len(events))
    return sum(e.device_time for e in events[-runs:]) / runs / 1e3


def phase_lowlat_times(card: str) -> dict[str, tuple[float, float]]:
    """Latency per window four ways for cfg1 and cfg2, and the flexible
    kernel at M=64.  Returns {kernel: (kernel ms, plain ms)} (CUDA events)."""
    fs = torch.tensor(FS, device="cuda")
    out = {}
    for name, n, mode, refine in (("cfg1", 1024, "rigid", False),
                                  ("cfg2", 4096, "flexible", True)):
        x = torch.from_numpy(clean_batch(1, n)[0]).cuda()
        pipeline.reset_dynamic_state()
        routed = lambda: pipeline.analyze_epoch(x[None], FS, mode=mode, refine=refine)  # noqa: E731
        routed()
        budget = pipeline.dynamic_state()["budget"].get((n, mode), 2)
        kernel = lambda: latency_cuda.analyze_window_lowlat(  # noqa: E731
            x, fs, mode=mode, max_candidates=budget, refine=refine)
        plain = lambda: _lowlat_plain(x, fs, mode, pipeline.default_k(mode),  # noqa: E731
                                      budget, refine)
        never = lambda: pipeline.analyze_epoch(  # noqa: E731
            x[None], FS, mode=mode, refine=refine, lowlat="never")
        dev_ms = _kernel_device_ms(kernel, f"lowlat_{mode}")
        k_ms, p_ms = event_ms(kernel), event_ms(plain)
        k2_ms, p2_ms = event_ms(kernel), event_ms(plain)
        walls = {label: _wall_ms(f) for label, f in
                 (("routed", routed), ("never", never), ("plain", plain), ("routed2", routed))}
        log(f"[9 times] {name} N={n} {mode}{' refine' if refine else ''} budget {budget}: "
            f"kernel device {dev_ms:.4f} ms (profiler, mean of 20); kernel call "
            f"{k_ms:.4f} / {k2_ms:.4f} ms, plain {p_ms:.4f} / {p2_ms:.4f} ms (CUDA events, "
            f"median of {TIMING_RUNS}); host wall with synchronize, median of {WALL_RUNS}: "
            f"routed analyze_epoch {walls['routed']:.4f} / {walls['routed2']:.4f} ms, "
            f"lowlat=never {walls['never']:.4f} ms, plain {walls['plain']:.4f} ms; {card}")
        out[f"lowlat_{mode}"] = (min(k_ms, k2_ms), min(p_ms, p2_ms))
    x = torch.from_numpy(overflow_window()).cuda()
    kernel = lambda: latency_cuda.analyze_window_lowlat(  # noqa: E731
        x, fs, mode="flexible", max_candidates=64, refine=True)
    res = kernel()
    assert int(res.n_candidates[0]) >= 64 and int(res.count[0]) < 4  # all 64 rounds run
    dev_ms = _kernel_device_ms(kernel, "lowlat_flexible")
    p_ms = event_ms(lambda: _lowlat_plain(x, fs, "flexible", 4, 64, True))
    log(f"[9 times] flexible kernel at M=64, N=4096 (71-candidate window, all 64 picks): "
        f"device {dev_ms:.4f} ms (profiler), call {event_ms(kernel):.4f} ms, plain "
        f"{p_ms:.4f} ms (CUDA events); {card}")
    n = latency_cuda.LOWLAT_MAX_N
    x = torch.from_numpy(clean_batch(1, n)[0]).cuda()
    kernel = lambda: latency_cuda.analyze_window_lowlat(  # noqa: E731
        x, fs, mode="flexible", max_candidates=2, refine=True)
    k_ms = event_ms(kernel)
    p_ms = event_ms(lambda: _lowlat_plain(x, fs, "flexible", 4, 2, True))
    dev_ms = _kernel_device_ms(kernel, "lowlat_flexible")
    log(f"[9 times] flexible kernel at N={n}, budget 2 (two-tone window): device "
        f"{dev_ms:.4f} ms (profiler), call {k_ms:.4f} ms, plain {p_ms:.4f} ms (CUDA events); "
        f"{card}")
    for n in (4096, latency_cuda.LOWLAT_MAX_N):
        x = torch.from_numpy(clean_batch(1, n)[0]).cuda()
        kernel = lambda: latency_cuda.analyze_window_lowlat(  # noqa: E731
            x, fs, mode="rigid", refine=True)
        res = kernel()
        k_ms = event_ms(kernel)
        p_ms = event_ms(lambda: _lowlat_plain(x, fs, "rigid", 5, 2, True))
        dev_ms = _kernel_device_ms(kernel, "lowlat_rigid")
        log(f"[9 times] rigid kernel at N={n} (two-tone window, count "
            f"{int(res.count[0])}, n_cand {int(res.n_candidates[0])}): device {dev_ms:.4f} ms "
            f"(profiler), call {k_ms:.4f} ms, plain {p_ms:.4f} ms (CUDA events); {card}")
    pipeline.reset_dynamic_state()
    return out


# ---------------------------------------------------------------- fused front end


#: 16384 is the largest N whose exchange buffers fit in shared memory;
#: 32768 and 65536 run through the global workspace.
B4_NS = (64, 1024, 4096, 16384, 32768, 65536)


def centred_windows(n: int, kind: str, b: int) -> np.ndarray:
    """``b`` windows of one kind (``lowlat_window`` at seeds 0..b-1), each
    mean-centred in float64, as the pipeline hands them to the front end."""
    x = np.stack([lowlat_window(n, kind, seed=s) for s in range(b)]).astype(np.float64)
    return (x - x.mean(axis=-1, keepdims=True)).astype(np.float32)


def float64_mags(x: np.ndarray) -> np.ndarray:
    ref = np.abs(np.fft.rfft(x.astype(np.float64))[:, : x.shape[-1] // 2])
    ref[:, 0] = 0.0
    return ref


def _halfspec_equals_plain(x: torch.Tensor, got: torch.Tensor, case: str) -> float:
    """Hold the front-end kernel's output ``got`` for ``x`` against the plain
    twin and float64 numpy.fft.  DC must be exactly 0.  Element by element,
    the kernel must lie within 2e-6 of the row maximum of float64 numpy.fft,
    and within 2e-6 of the row maximum of the twin plus the twin's own
    distance from float64 there: the kernel is an FFT, the twin a four-step
    of ``torch.matmul`` calls and the less accurate of the two, and on
    sparse (impulse) windows at N = 32768 they differ by 3e-6 of the row
    maximum.  Returns the max abs difference from the twin."""
    g = got.cpu().numpy()
    w = _halfspec_magnitudes_fused_plain(x).cpu().numpy()
    ref = float64_mags(x.cpu().numpy())
    assert g.shape == w.shape and g.dtype == np.float32, (case, g.shape, g.dtype)
    assert not g[:, 0].any(), f"{case}: DC bin not zero"
    scale = np.abs(w).max(axis=-1, keepdims=True)
    err = np.abs(g - ref)
    bad = err > 2e-6 * scale
    assert not bad.any(), (case, "vs float64", int(bad.sum()),
                           float((err / np.maximum(scale, 1e-30)).max()))
    diff = np.abs(g - w)
    bad = diff > 2e-6 * scale + np.abs(w - ref)
    assert not bad.any(), (case, "vs twin", int(bad.sum()),
                           float((diff / np.maximum(scale, 1e-30)).max()))
    return float(diff.max(initial=0.0))


def phase_halfspec_vs_plain() -> float:
    """The front-end kernel and its twin against float64 numpy.fft and each
    other; returns the max abs difference between them."""
    before = fft_cuda.launches
    worst = 0.0
    cases = 0
    for n in B4_NS:
        b = 4 if n > 4096 else 16
        line = []
        for kind in ("modal", "noise", "impulse", "flat"):
            xn = centred_windows(n, kind, b)
            x = torch.from_numpy(xn).cuda()
            got = halfspec_magnitudes_fused(x)
            worst = max(worst, _halfspec_equals_plain(x, got, f"{kind} N={n}"))
            cases += 1
            ref = float64_mags(xn)
            if not ref.any():
                assert not got.any(), f"{kind} N={n}: a zero window gave a non-zero spectrum"
                line.append(f"{kind} all zero")
                continue
            errs = [float(np.linalg.norm(m.cpu().numpy() - ref) / np.linalg.norm(ref))
                    for m in (got, _halfspec_magnitudes_fused_plain(x))]
            assert max(errs) <= 1e-6, (kind, n, errs)
            line.append(f"{kind} {errs[0]:.3e}/{errs[1]:.3e}")
        log(f"[10 fused front end] N={n:5d} B={b}: normwise error vs float64 numpy.fft, "
            f"kernel/plain: {'; '.join(line)}")
    assert fft_cuda.launches > before, "the front-end kernel was never launched"
    log(f"[10 fused front end] all {cases} cases: kernel within 2e-6 of the row maximum of "
        f"float64 numpy.fft and of the plain twin (plus the twin's own error), DC 0; launches "
        f"{fft_cuda.launches - before}; max abs diff from the twin {worst:.3g}")
    return worst


def phase_pallas_path(corpora: dict[str, np.ndarray]) -> tuple[int, float]:
    """Drive ``analyze_epoch(backend="pallas")`` on the card; returns the
    front-end kernel's launches on that path and the max abs difference of
    its calls against the plain twin."""
    pipeline.reset_dynamic_state()
    results, budgets = {}, {}
    calls = []
    wrapper = fft_cuda.halfspec_magnitudes_fused

    def tapped(x):
        out = wrapper(x)
        calls.append((x.clone(), out.clone()))
        return out

    fft_cuda.halfspec_magnitudes_fused = tapped
    fft_cuda.launches = 0
    try:
        for name, x in corpora.items():
            xs = torch.from_numpy(x).cuda()
            for epoch in range(2):
                res = pipeline.analyze_epoch(xs, FS, n_fft=N_FFT, mode="flexible", refine=True,
                                             lowlat="never", backend="pallas")
                torch.cuda.synchronize()
                stats = dict(pipeline.last_dynamic_stats())
                log(f"[11 pallas path] {name} epoch {epoch}: count>0 in "
                    f"{int((res.count > 0).sum())}/{x.shape[0]} windows; {stats}")
            results[name], budgets[name] = res, stats
        others = {}
        for mode, name in (("rigid", "clean"), ("adaptive", "noisy")):
            others[mode] = pipeline.analyze_epoch(
                torch.from_numpy(corpora[name][:256]).cuda(), FS, n_fft=N_FFT, mode=mode,
                backend="pallas")
        # One window: the single-window route is the matmul backend's only,
        # so this takes the batched path and its front-end kernel.
        lat_before = sum(latency_cuda.launches.values())
        fe_before = fft_cuda.launches
        one = pipeline.analyze_epoch(torch.from_numpy(corpora["clean"][:1]).cuda(), FS,
                                     n_fft=N_FFT, mode="flexible", refine=True, backend="pallas")
        torch.cuda.synchronize()
        assert fft_cuda.launches > fe_before, "one window with backend='pallas' skipped B4"
        assert sum(latency_cuda.launches.values()) == lat_before, "it took the latency kernel"
        launches = fft_cuda.launches
    finally:
        fft_cuda.halfspec_magnitudes_fused = wrapper
    log(f"[11 pallas path] front-end kernel launches on the path: {launches} (calls at "
        f"{[tuple(c[0].shape) for c in calls]}); one window launched it and no latency kernel")
    assert launches > 0, "the backend='pallas' path never launched the front-end kernel"
    assert launches == len(calls), (launches, len(calls))
    assert budgets["noisy"]["tier"] is not None, "the noisy epoch did not run two-tier"
    worst = 0.0
    for i, (x, got) in enumerate(calls):
        worst = max(worst, _halfspec_equals_plain(x, got, f"pallas-path call {i}"))
    log(f"[11 pallas path] all {len(calls)} front-end calls equal the plain twin; max abs "
        f"diff {worst:.3g}")
    del calls

    oracle = _load_oracle()
    for name, x in corpora.items():
        res = results[name]
        assert res.freq.shape == (x.shape[0], 4) and bool(torch.isfinite(res.freq).all())
        for i in range(32):
            want = oracle.oracle_analyze(x[i].astype(np.float64), FS, "flexible")
            c = int(res.count[i])
            assert c == len(want), (name, i, c, len(want))
            assert res.idx[i, :c].tolist() == [p["idx"] for p in want], (name, i)
            np.testing.assert_allclose(res.freq[i, :c].cpu().numpy(),
                                       [p["freq"] for p in want], atol=1e-4, rtol=1e-6)
        cpu = _cpu_reference(
            torch.tensor(x[:256]), FS, n_fft=N_FFT, mode="flexible", refine=True,
            lowlat="never", backend="pallas", max_candidates=budgets[name]["candidate_budget"],
        )
        gpu = type(res)(*(f[:256] for f in res))
        try:
            _assert_same(gpu, cpu, ("count", "idx", "n_candidates", "n_required"),
                         (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-6)), f"{name} pallas vs CPU")
        except AssertionError as err:
            raise AssertionError(
                f"{err}\n{_which_side(x, gpu, cpu, oracle, 'pallas')}") from err
        log(f"[11 pallas path] {name}: 32 windows equal to the float64 oracle, 256 windows "
            f"equal to the CPU run at budget {budgets[name]['candidate_budget']}")
    for mode, name in (("rigid", "clean"), ("adaptive", "noisy")):
        cpu = _cpu_reference(torch.tensor(corpora[name][:256]), FS, n_fft=N_FFT, mode=mode,
                             backend="pallas")
        _assert_same(others[mode], cpu, ("count", "idx"),
                     (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-5)), f"{mode} pallas vs CPU")
        log(f"[11 pallas path] {mode} B=256 ({name}): decisions equal to the CPU run; "
            f"count>0 in {int((others[mode].count > 0).sum())} windows")
    want = oracle.oracle_analyze(corpora["clean"][0].astype(np.float64), FS, "flexible")
    assert one.idx[0, :int(one.count[0])].tolist() == [p["idx"] for p in want]
    log(f"[11 pallas path] one window: idx {one.idx[0].tolist()}, equal to the float64 oracle")
    return launches, worst


# ---------------------------------------------------------------- pre-selected scans


#: Rows of phase 12; at 65536 the scans kernel reads the row from device memory.
SCANS_HS = (32, 2048, 32768, 65536)


def phase_scans_vs_plain(corpora: dict[str, np.ndarray]) -> tuple[int, float]:
    """The scans kernel against its plain twin and against the select+scan
    kernel on that kernel's own picks, then ``prominence_peaks_batch`` on
    the noisy spectra; returns the scans kernel's launches in that last run
    and the max abs float difference against the twin."""
    worst = 0.0
    cases = 0
    for kind in ("modal", "noise", "flat", "ties"):
        for h in SCANS_HS:
            b = 16 if h > 4096 else 64
            mags = torch.from_numpy(spectra(b, h, seed=h + len(kind), kind=kind)).cuda()
            diffs = []
            for m in (2, 12, 32, 128):
                cid, is_cand, cmag, s_prom, s_bins, _, _ = prominence_select_scan(mags, m)
                n_valid = is_cand.sum(dim=-1).to(torch.int32)
                prom, bins = prominence_scans(mags, cid, cmag, n_valid)
                w_prom, w_bins = _prominence_scans_plain(mags, cid, cmag, n_valid)
                case = f"{kind} H={h} M={m}"
                np.testing.assert_array_equal(bins.cpu().numpy(), w_bins.cpu().numpy(),
                                              err_msg=f"{case} bins")
                np.testing.assert_allclose(prom.cpu().numpy(), w_prom.cpu().numpy(),
                                           rtol=1e-6, atol=0, err_msg=f"{case} prom")
                diffs.append(float((prom - w_prom).abs().max()) if prom.numel() else 0.0)
                # Both kernels run scan_at on the same row: the same bits.
                valid = is_cand.cpu().numpy()
                assert np.array_equal(prom.cpu().numpy()[valid], s_prom.cpu().numpy()[valid]), case
                assert np.array_equal(bins.cpu().numpy()[valid], s_bins.cpu().numpy()[valid]), case
                cases += 1
            worst = max(worst, *diffs)
            log(f"[12 scans==plain] {kind:5s} H={h:5d} B={b}: equal to the plain twin and to "
                f"the select+scan kernel on its picks; max|float diff| at M=2/12/32/128 = "
                f"{', '.join(f'{d:.3g}' for d in diffs)}")
    log(f"[12 scans==plain] all {cases} cases equal")
    hand = phase_scans_hand_made()
    worst = max(worst, hand)

    mags = centered_mags(torch.from_numpy(corpora["noisy"]).cuda()).contiguous()
    budget = 32
    detector_cuda.scan_launches = 0
    got = prominence_peaks_batch(mags, FS, N_FFT, max_candidates=budget)
    torch.cuda.synchronize()
    launches = detector_cuda.scan_launches
    want = prominence_peaks_fused(mags, FS, N_FFT, max_candidates=budget)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"prominence_peaks_batch {f}"
    assert launches > 0, "prominence_peaks_batch never launched the scans kernel"
    log(f"[12 scans path] prominence_peaks_batch on the noisy spectra [{BATCH}, {N_FFT // 2}] "
        f"at M={budget}: {launches} scans-kernel launch(es); every field equal to "
        f"prominence_peaks_fused; count>0 in {int((got.count > 0).sum())} windows")
    return launches, worst


def _scans_equal_plain(mags, cid, cmag, n_valid, case: str) -> float:
    """The scans kernel against its plain twin on the given slots: widths
    equal, prominences within rtol 1e-6.  Returns the max abs difference."""
    prom, bins = prominence_scans(mags, cid, cmag, n_valid)
    w_prom, w_bins = _prominence_scans_plain(mags, cid, cmag, n_valid)
    np.testing.assert_array_equal(bins.cpu().numpy(), w_bins.cpu().numpy(),
                                  err_msg=f"{case} bins")
    np.testing.assert_allclose(prom.cpu().numpy(), w_prom.cpu().numpy(), rtol=1e-6, atol=0,
                               err_msg=f"{case} prom")
    return float((prom - w_prom).abs().max()) if prom.numel() else 0.0


def phase_scans_hand_made() -> float:
    """The scans kernel's wider contract (the JAX kernel's): a peak that is
    not ``x[cid]``, a ``cid`` anywhere in int32, a count outside [0, M].
    Returns the max abs difference from the twin."""
    worst = 0.0
    cases = 0
    for kind in ("modal", "noise", "flat", "ties"):
        for h in SCANS_HS:
            b = 16 if h > 4096 else 64
            mags = torch.from_numpy(spectra(b, h, seed=h + len(kind), kind=kind)).cuda()
            cid, is_cand, cmag, _, _, _, _ = prominence_select_scan(mags, 12)
            n_valid = is_cand.sum(dim=-1).to(torch.int32)
            for scale in (0.5, 2.0):
                worst = max(worst, _scans_equal_plain(
                    mags, cid, cmag * scale, n_valid, f"{kind} H={h} cmag*{scale}"))
            # Edge and out-of-range bins, with peaks from the row and beyond it.
            edge = torch.tensor([0, 1, h - 2, h - 1, -1, h, h + 7], dtype=torch.int32,
                                device="cuda").expand(b, -1).contiguous()
            rows = torch.arange(b, device="cuda")[:, None]
            peaks = mags[rows, edge.clamp(0, h - 1).long()]
            peaks[:, 4] = mags.amax(-1) * 0.5
            peaks[:, 5] = mags.mean(-1)
            peaks[:, 6] = mags.amax(-1) * 2.0
            full = torch.full((b,), edge.shape[1], dtype=torch.int32, device="cuda")
            worst = max(worst, _scans_equal_plain(mags, edge, peaks, full, f"{kind} H={h} edge"))
            for nv in (-3, edge.shape[1] + 5):
                worst = max(worst, _scans_equal_plain(
                    mags, edge, peaks, torch.full_like(full, nv), f"{kind} H={h} n_valid={nv}"))
            cases += 5
    log(f"[12 scans==plain] hand-made slots: {cases} cases (cmag = x[cid]*0.5 and *2, cid in "
        f"{{0, 1, H-2, H-1, -1, H, H+7}}, n_valid -3 and M+5) equal to the plain twin; max abs "
        f"float diff {worst:.3g}")
    return worst


def phase_new_times(corpora: dict[str, np.ndarray], card: str) -> dict[str, dict[str, float]]:
    """Returns {kernel: {"ms", "plain_ms", "library_ms"}} for the front-end
    and scans kernels (CUDA events, best of the two medians)."""
    x = torch.from_numpy(corpora["noisy"]).cuda()
    x = (x - x.mean(dim=-1, keepdim=True)).contiguous()
    fns = {
        "plain": lambda: _halfspec_magnitudes_fused_plain(x),
        "kernel": lambda: halfspec_magnitudes_fused(x),
        "rfft": lambda: halfspec_magnitudes(x, backend="xla"),
    }
    order = ("plain", "kernel", "rfft", "rfft", "kernel", "plain")
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(event_ms(fns[k]))
    dev_ms = _kernel_device_ms(fns["kernel"], "halfspec_fft_kernel")
    b_ms, b_by = bound(6 * x.numel(), BATCH * rfft_mag_flops(N_FFT))
    log(f"[13 times] fused front end B={BATCH} N={N_FFT}: kernel "
        f"{' / '.join(f'{t:.4f}' for t in times['kernel'])} ms (device {dev_ms:.4f} ms, "
        f"profiler mean of 20), plain twin {' / '.join(f'{t:.4f}' for t in times['plain'])} "
        f"ms, torch.fft.rfft (backend='xla') {' / '.join(f'{t:.4f}' for t in times['rfft'])} "
        f"ms; bound {b_ms:.4f} ms ({b_by}); CUDA-event medians of {TIMING_RUNS}, "
        f"P-K-L-L-K-P order; {card}")
    out = {"halfspec_fused": {"ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
                              "library_ms": min(times["rfft"])}}

    for name, xn in corpora.items():
        xs = torch.from_numpy(xn).cuda()
        rates = {"pallas": [], "matmul": []}
        for backend in ("pallas", "matmul", "matmul", "pallas"):
            ms = event_ms(lambda: pipeline.analyze_epoch(
                xs, FS, n_fft=N_FFT, mode="flexible", refine=True, lowlat="never",
                backend=backend))
            rates[backend].append(BATCH / (ms / 1e3))
        log(f"[13 times] epoch {name} B={BATCH} N={N_FFT} windows/s: backend='pallas' "
            f"{' / '.join(f'{r:.1f}' for r in rates['pallas'])}, backend='matmul' "
            f"{' / '.join(f'{r:.1f}' for r in rates['matmul'])} (CUDA-event medians of "
            f"{TIMING_RUNS}, P-M-M-P order; {card})")

    mags = centered_mags(torch.from_numpy(corpora["noisy"]).cuda()).contiguous()
    m = 32
    cid, is_cand, cmag, _, _, _ = prominence_select(mags, m)
    n_valid = is_cand.sum(dim=-1).to(torch.int32)
    p1 = event_ms(lambda: _prominence_scans_plain(mags, cid, cmag, n_valid))
    k1 = event_ms(lambda: prominence_scans(mags, cid, cmag, n_valid))
    k2 = event_ms(lambda: prominence_scans(mags, cid, cmag, n_valid))
    p2 = event_ms(lambda: _prominence_scans_plain(mags, cid, cmag, n_valid))
    log(f"[13 times] scans B={BATCH} H={N_FFT // 2} M={m} (noisy spectra, "
        f"{int(n_valid.sum())} valid slots): kernel {k1:.4f} / {k2:.4f} ms, plain twin "
        f"{p1:.4f} / {p2:.4f} ms (CUDA-event medians of {TIMING_RUNS}, P-K-K-P; {card})")
    out["prominence_scans"] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": None}
    # Call times at every budget first, then the profiler's device times.
    slots = {}
    for m in (2, 12, 32, 128):
        cid, is_cand, cmag, _, _, _ = prominence_select(mags, m)
        n_valid = is_cand.sum(dim=-1).to(torch.int32)
        fn = lambda c=cid, p=cmag, v=n_valid: prominence_scans(mags, c, p, v)  # noqa: E731
        slots[m] = (fn, int(n_valid.sum()), event_ms(fn))
    for m, (fn, valid, call_ms) in slots.items():
        dev_ms = _kernel_device_ms(fn, "preselected_scans_kernel")
        log(f"[13 times] scans B={BATCH} H={N_FFT // 2} M={m} ({valid} valid slots): device "
            f"{dev_ms:.4f} ms (profiler, mean of 20), call {call_ms:.4f} ms (CUDA-event median "
            f"of {TIMING_RUNS}); {card}")
    return out


# ---------------------------------------------------------------- records, streams, Welch

#: Records per output data rate of the gateway at ``benchmarks/scale_soak.py``'s
#: size: 256 sensors x 3 axes, at each of 2 rates.
GATEWAY_RECORDS = 768
#: The gateway's default Welch segment (``gateway/config.py``: window 1024,
#: hop 0 = 50 %, hann).
WELCH_WINDOW = 1024
#: BASELINE config 4: 64 channels, 16 windows of N=8192 a channel.
STREAM_CHANNELS, STREAM_WINDOW, STREAM_T = 64, 8192, 131072
DECISIONS = ("count", "idx", "n_candidates", "n_required")


def _zero_counts() -> None:
    detector_cuda.launches = 0
    detector_cuda.scan_launches = 0
    fft_cuda.launches = 0
    for key in latency_cuda.launches:
        latency_cuda.launches[key] = 0


def _counts() -> dict[str, int]:
    return {"prominence_select_scan": detector_cuda.launches,
            "lowlat_flexible": latency_cuda.launches["lowlat_flexible"],
            "lowlat_rigid": latency_cuda.launches["lowlat_rigid"],
            "halfspec_fused": fft_cuda.launches,
            "prominence_scans": detector_cuda.scan_launches}


class _Taps:
    """While active, records every call of the B1, B2/B3 and B4 wrappers
    (the pipeline looks each up at call time), so that :meth:`check` can
    hold each call against its plain twin on its own inputs."""

    def __enter__(self):
        self.b1, self.lowlat, self.b4 = [], [], []
        self._saved = b1, lowlat, b4 = (detector_cuda.prominence_select_scan,
                                        latency_cuda.analyze_window_lowlat,
                                        fft_cuda.halfspec_magnitudes_fused)

        def tap_b1(mags, m):
            out = b1(mags, m)
            self.b1.append((mags.clone(), m, tuple(o.clone() for o in out)))
            return out

        def tap_lowlat(x, fs, **kw):
            out = lowlat(x, fs, **kw)
            self.lowlat.append((x.clone(), fs.clone(), kw, type(out)(*(o.clone() for o in out))))
            return out

        def tap_b4(x):
            out = b4(x)
            self.b4.append((x.clone(), out.clone()))
            return out

        detector_cuda.prominence_select_scan = tap_b1
        latency_cuda.analyze_window_lowlat = tap_lowlat
        fft_cuda.halfspec_magnitudes_fused = tap_b4
        return self

    def __exit__(self, *exc):
        (detector_cuda.prominence_select_scan, latency_cuda.analyze_window_lowlat,
         fft_cuda.halfspec_magnitudes_fused) = self._saved

    def check(self, tag: str) -> dict[str, float]:
        """Every tapped call against its plain twin; returns the max abs
        float difference per kernel and frees the taps."""
        worst = {"prominence_select_scan": 0.0, "lowlat_flexible": 0.0, "lowlat_rigid": 0.0,
                 "halfspec_fused": 0.0}
        for i, (mags, m, got) in enumerate(self.b1):
            err = _kernel_equals_plain(mags, m, got,
                                       f"{tag} select+scan call {i} {tuple(mags.shape)} M={m}")
            worst["prominence_select_scan"] = max(worst["prominence_select_scan"], err)
        for i, (x, fs, kw, got) in enumerate(self.lowlat):
            mode = kw["mode"]
            want = _lowlat_plain(x, fs, mode, kw["k"], kw["max_candidates"], kw["refine"])
            worst[f"lowlat_{mode}"] = max(worst[f"lowlat_{mode}"], _lowlat_equals_plain(
                got, want, mode, f"{tag} lowlat call {i} N={x.shape[-1]} {mode}"))
        for i, (x, got) in enumerate(self.b4):
            worst["halfspec_fused"] = max(worst["halfspec_fused"], _halfspec_call_check(
                x, got, f"{tag} front-end call {i} {tuple(x.shape)}"))
        log(f"[{tag}] every kernel call equal to its plain twin: select+scan {len(self.b1)}, "
            f"latency {len(self.lowlat)}, front end {len(self.b4)} calls; max abs float diff "
            f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }")
        self.b1, self.lowlat, self.b4 = [], [], []
        return worst


def _halfspec_call_check(x: torch.Tensor, got: torch.Tensor, case: str) -> float:
    """A front-end call of up to 65536 windows against its plain twin: every
    row on the card within 4e-6 of the twin's row maximum (the two differ by
    up to 3e-6 of it on impulse windows, phase 10), DC 0; and every 64th
    row by phase 10's element-wise checks against the twin and float64
    numpy.fft.  Returns the max abs difference from the twin."""
    twin = _halfspec_magnitudes_fused_plain(x)
    diff = (got - twin).abs()
    assert bool((diff <= 4e-6 * twin.amax(dim=-1, keepdim=True)).all()), (case, "vs twin")
    assert not bool(got[:, 0].any()), f"{case}: DC bin not zero"
    rows = torch.arange(0, x.shape[0], 64, device=x.device)
    _halfspec_equals_plain(x[rows], got[rows], case)
    return float(diff.max())


def _max_err(*dicts: dict[str, float]) -> dict[str, float]:
    out: dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def _assert_records_equal(got, want, where: str) -> None:
    """Per-record views: bucket, row and count equal, every slot's index
    equal, freq and mag to the 4-dp rounding step."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.n_fft, g.count) == (w.n_fft, w.count), (where, i, g.count, w.count)
        for s in range(g.count):
            pg, pw = g.peak(s), w.peak(s)
            assert pg["idx"] == pw["idx"], (where, i, s)
            for f in ("freq", "mag"):
                assert abs(pg[f] - pw[f]) <= 1e-4 + 1e-5 * abs(pw[f]), (where, i, s, f)
        for f in ("n_candidates", "n_required"):
            assert int(getattr(g.result, f)[g.row]) == int(getattr(w.result, f)[w.row]), \
                (where, i, f)


def _dtoh_copies(fn) -> int:
    """Device-to-host copies the card ran during ``fn()`` (``torch.profiler``
    memcpy events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "DtoH" in e.name)


def gateway_records(signals) -> list[tuple[np.ndarray, float]]:
    """One gateway epoch at scale: 768 records at fs=500 with lengths
    2500..4096 (the 4096 bucket), 768 at fs=1000 with 5000..8192 (the 8192
    bucket), each 1-4 damped modes with noise of std 0.05..0.5, and one
    2048-sample record at the non-dyadic 99.7 Hz in a bucket of its own."""
    rng = np.random.default_rng(2026)
    recs = []
    for fs, lo, hi in ((500.0, 2500, 4096), (1000.0, 5000, 8192)):
        for n in rng.integers(lo, hi + 1, GATEWAY_RECORDS):
            x = signals.modal_signal(int(n), fs, noise=float(rng.uniform(0.05, 0.5)),
                                     seed=int(rng.integers(1 << 31)))
            recs.append((x.astype(np.float32), fs))
    recs.append((signals.modal_signal(2048, 99.7, seed=99).astype(np.float32), 99.7))
    return recs


def phase_records(oracle, signals, card: str) -> tuple[dict[str, int], dict[str, float]]:
    """``analyze_records`` through a ``SpectralPipeline`` on one gateway
    epoch (1537 records, three buckets) in flexible (refine), adaptive and
    rigid mode.  Returns the path's kernel launches and the max abs float
    difference of its kernel calls from their plain twins."""
    recs = gateway_records(signals)
    modes = {"flexible": dict(mode="flexible", refine=True), "adaptive": dict(mode="adaptive"),
             "rigid": dict(mode="rigid")}
    results, buckets = {}, []
    _zero_counts()
    with _Taps() as taps:
        for name, kw in modes.items():
            pipeline.reset_dynamic_state()
            pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(**kw))
            results[name] = batching.analyze_records(
                recs, analyze=pipe, on_bucket=lambda n, idxs: buckets.append((n, len(idxs))))
            log(f"[14 records] {name}: buckets (n_fft, records) {buckets[-3:]}; "
                f"count>0 in {sum(rp.count > 0 for rp in results[name])}/{len(recs)} records; "
                f"{pipe.last_metrics}")
    launches = _counts()
    log(f"[14 records] kernel launches on the records path: {launches}")
    assert buckets[:3] == [(2048, 1), (4096, GATEWAY_RECORDS), (8192, GATEWAY_RECORDS)], buckets
    assert launches["prominence_select_scan"] > 0, "the records path never launched B1"
    # Every bucket passes its lengths, so even the one-record bucket takes
    # the batched path, as in the JAX package.
    assert launches["lowlat_flexible"] == launches["lowlat_rigid"] == 0, launches
    err = taps.check("14 records")

    sub = list(range(32)) + list(range(GATEWAY_RECORDS, GATEWAY_RECORDS + 31)) + [len(recs) - 1]
    picks = (list(range(0, GATEWAY_RECORDS, 50))
             + list(range(GATEWAY_RECORDS, 2 * GATEWAY_RECORDS, 51)) + [len(recs) - 1])
    for name, kw in modes.items():
        res = results[name]
        assert all(t.device.type == "cpu" for t in res[0].result), "a view left on the card"
        cpu_pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(device="cpu", **kw))
        with _one_cpu_thread():
            cpu = batching.analyze_records([recs[i] for i in sub], analyze=cpu_pipe)
        _assert_records_equal([res[i] for i in sub], cpu, f"records {name} vs CPU")
        for i in picks:
            samples, fs = recs[i]
            want = [p["idx"] for p in oracle.oracle_analyze(samples.astype(np.float64), fs, name)]
            got = [res[i].peak(s)["idx"] for s in range(res[i].count)]
            assert got == want, (name, i, got, want)
        log(f"[14 records] {name}: {len(sub)} records equal to the CPU run, {len(picks)} "
            f"(the 99.7 Hz one among them) to the float64 oracle")

    # Copies per bucket: one profiler window per bucket, around a call on
    # that bucket's records alone, after a warm-up call on them.
    groups: dict[int, list] = {}
    for rec in recs:
        groups.setdefault(1 << (len(rec[0]) - 1).bit_length(), []).append(rec)
    copies = {}
    for label, kw in (("flexible, static budget 32", dict(mode="flexible", max_candidates=32)),
                      *((f"{name}, default budget", kw) for name, kw in modes.items())):
        pipeline.reset_dynamic_state()
        pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(**kw))
        copies[label] = {}
        for n_fft, group in sorted(groups.items()):
            batching.analyze_records(group, analyze=pipe)
            copies[label][n_fft] = _dtoh_copies(
                lambda: batching.analyze_records(group, analyze=pipe))
        log(f"[14 records] device-to-host copies per bucket {{n_fft: copies}}, {label}: "
            f"{copies[label]} (torch.profiler memcpy events)")
    assert all(0 < c <= 2 for c in copies["flexible, static budget 32"].values()), copies
    for name, kw in modes.items():
        pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(**kw))
        sec = _wall_ms(lambda: batching.analyze_records(recs, analyze=pipe), runs=3,
                       warmup=1) / 1e3
        log(f"[14 times] analyze_records {name}: {len(recs) / sec:.1f} records/s ({sec * 1e3:.2f} "
            f"ms for {len(recs)} records in 3 buckets, host wall incl. the copies, median of 3; "
            f"{card})")
    pipeline.reset_dynamic_state()
    return launches, err


def gateway_welch_records() -> list[tuple[np.ndarray, float]]:
    """The gateway's Welch inputs at scale: 768 records of 16384 samples at
    fs=500 and 768 of 32768 at fs=1000 (31 and 63 segments of 1024), each
    unit broadband noise plus two weak tones (amplitude 0.15..0.5)."""
    rng = np.random.default_rng(2027)
    recs = []
    for fs, n in ((500.0, 16384), (1000.0, 32768)):
        t = np.arange(n) / fs
        x = rng.standard_normal((GATEWAY_RECORDS, n))
        for _ in range(2):
            f = rng.uniform(0.05, 0.45, (GATEWAY_RECORDS, 1)) * fs
            a = rng.uniform(0.15, 0.5, (GATEWAY_RECORDS, 1))
            x += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi, (GATEWAY_RECORDS, 1)))
        recs += [(row, fs) for row in x.astype(np.float32)]
    return recs


def _spec_from_mags(mags: np.ndarray) -> np.ndarray:
    """A length-2H complex vector whose |.| over the first half is ``mags``
    (the float64 oracle detectors take a spectrum)."""
    full = np.zeros(2 * len(mags), dtype=np.complex128)
    full[: len(mags)] = mags
    return full


def oracle_welch_mags(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Float64 model of ``analyze_welch``'s spectrum (``tests/test_welch_oracle.py``,
    restated here without its JAX imports): frame, mean-detrend, pad,
    normalized hann over the data, |rfft| with DC zeroed, RMS over segments."""
    x = np.asarray(x, np.float64)
    w = (len(x) - window) // hop + 1
    n_fft = 1 << (window - 1).bit_length()
    segs = np.stack([x[s * hop: s * hop + window] for s in range(w)])
    segs = segs - segs.mean(axis=1, keepdims=True)
    segs = np.pad(segs, ((0, 0), (0, n_fft - window)))
    i = np.arange(n_fft, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / max(window - 1.0, 1.0))
    win[window:] = 0.0
    segs = segs * (win / win.mean())
    mags = np.abs(np.fft.rfft(segs))[:, : n_fft // 2]
    mags[:, 0] = 0.0
    return np.sqrt(np.mean(mags * mags, axis=0))


def phase_welch(oracle, card: str) -> tuple[dict[str, int], dict[str, float]]:
    """``analyze_records_welch(..., analyze=pipeline.welch)`` at the
    gateway's Welch defaults on 1536 long records, with ``backend="matmul"``
    and ``"pallas"``.  Returns launches and max abs float differences."""
    recs = gateway_welch_records()
    segments = GATEWAY_RECORDS * (31 + 63)
    results, buckets = {}, []
    pipes = {b: pipeline.SpectralPipeline(pipeline.PipelineConfig(refine=True, backend=b))
             for b in ("matmul", "pallas")}
    _zero_counts()
    with _Taps() as taps:
        for backend, pipe in pipes.items():
            results[backend] = batching.analyze_records_welch(
                recs, window=WELCH_WINDOW, analyze=pipe.welch,
                on_bucket=lambda n, idxs: buckets.append((n, len(idxs))))
            log(f"[15 welch] backend={backend}: count>0 in "
                f"{sum(rp.count > 0 for rp in results[backend])}/{len(recs)} records")
    launches = _counts()
    log(f"[15 welch] kernel launches on the Welch path: {launches}")
    assert buckets == [(WELCH_WINDOW, GATEWAY_RECORDS)] * 4, buckets
    assert launches["prominence_select_scan"] > 0 and launches["halfspec_fused"] > 0, launches
    err = taps.check("15 welch")

    sub = list(range(32)) + list(range(GATEWAY_RECORDS, GATEWAY_RECORDS + 32))
    picks = (list(range(0, GATEWAY_RECORDS, 48))
             + list(range(GATEWAY_RECORDS, 2 * GATEWAY_RECORDS, 48)))
    want = {i: [p["idx"] for p in oracle.oracle_prominence_peaks(
        _spec_from_mags(oracle_welch_mags(recs[i][0], WELCH_WINDOW, WELCH_WINDOW // 2)),
        recs[i][1])] for i in picks}
    for backend, res in results.items():
        assert all(rp.count > 0 for rp in res), "a Welch record without a peak"
        cpu_pipe = pipeline.SpectralPipeline(pipeline.PipelineConfig(refine=True, backend=backend,
                                                                     device="cpu"))
        with _one_cpu_thread():
            cpu = batching.analyze_records_welch([recs[i] for i in sub], window=WELCH_WINDOW,
                                                 analyze=cpu_pipe.welch)
        _assert_records_equal([res[i] for i in sub], cpu, f"welch {backend} vs CPU")
        for i in picks:
            got = [res[i].peak(s)["idx"] for s in range(res[i].count)]
            assert got == want[i], (backend, i, got, want[i])
        log(f"[15 welch] backend={backend}: {len(sub)} records equal to the CPU run, "
            f"{len(picks)} to the float64 Welch model under the float64 oracle detector")
    for backend, pipe in pipes.items():
        sec = _wall_ms(lambda: batching.analyze_records_welch(
            recs, window=WELCH_WINDOW, analyze=pipe.welch), runs=3, warmup=1) / 1e3
        log(f"[15 times] analyze_records_welch backend={backend}: {segments / sec:.1f} "
            f"segments/s, {len(recs) / sec:.1f} records/s ({sec * 1e3:.2f} ms a call, host wall "
            f"incl. the copies, median of 3; {card})")
    return launches, err


def stream_records(signals) -> np.ndarray:
    """BASELINE config 4's stream, ``[64, 131072]`` float32 at fs=500: each
    channel 16 consecutive N=8192 stretches of 1-4 damped modes (re-excited
    every stretch) with noise of std 0.05..0.5."""
    rng = np.random.default_rng(2028)
    rows = [np.concatenate([signals.modal_signal(STREAM_WINDOW, FS,
                                                 noise=float(rng.uniform(0.05, 0.5)),
                                                 seed=int(rng.integers(1 << 31)))
                            for _ in range(STREAM_T // STREAM_WINDOW)])
            for _ in range(STREAM_CHANNELS)]
    return np.stack(rows).astype(np.float32)


def phase_streams(oracle, signals, card: str) -> tuple[dict[str, int], dict[str, float]]:
    """``analyze_stream`` on BASELINE cfg4 at hop 8192 (1024 windows) and
    4096 (1984 windows) with both front ends, then ``spectrogram`` and
    ``welch_psd`` on the same records.  Returns launches and errors."""
    import scipy.signal

    x = stream_records(signals)
    runs = [(hop, backend) for hop in (STREAM_WINDOW, STREAM_WINDOW // 2)
            for backend in ("matmul", "pallas")]
    results = {}
    pipeline.reset_dynamic_state()
    _zero_counts()
    with _Taps() as taps:
        for hop, backend in runs:
            results[hop, backend] = streaming.analyze_stream(
                x, FS, STREAM_WINDOW, hop, mode="flexible", refine=True, backend=backend)
            res = results[hop, backend]
            log(f"[16 streams] hop={hop} backend={backend}: windows {tuple(res.count.shape)}; "
                f"count>0 in {int((res.count > 0).sum())}; {dict(pipeline.last_dynamic_stats())}")
        freqs, mags = streaming.spectrogram(x, FS, STREAM_WINDOW, backend="pallas")
        psd = {b: streaming.welch_psd(x, FS, WELCH_WINDOW, backend=b)[1]
               for b in ("matmul", "pallas")}
        torch.cuda.synchronize()
    launches = _counts()
    log(f"[16 streams] kernel launches on the stream paths: {launches}")
    assert launches["prominence_select_scan"] > 0 and launches["halfspec_fused"] > 0, launches
    err = taps.check("16 streams")

    w = STREAM_T // STREAM_WINDOW
    assert results[STREAM_WINDOW, "matmul"].count.shape == (STREAM_CHANNELS, w)
    assert results[STREAM_WINDOW // 2, "matmul"].count.shape == (STREAM_CHANNELS, 2 * w - 1)
    for (hop, backend), res in results.items():
        assert bool(torch.isfinite(res.freq).all())
        with _one_cpu_thread():
            cpu = streaming.analyze_stream(x[:4], FS, STREAM_WINDOW, hop, mode="flexible",
                                           refine=True, backend=backend, device="cpu")
        gpu = type(res)(*(f[:4] for f in res))
        _assert_same(gpu, cpu, DECISIONS, (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-6)),
                     f"stream hop={hop} {backend} vs CPU")
        if hop == STREAM_WINDOW:
            for ch in range(2):
                for i in range(w):
                    seg = x[ch, i * STREAM_WINDOW:(i + 1) * STREAM_WINDOW].astype(np.float64)
                    want = [p["idx"] for p in oracle.oracle_analyze(seg, FS, "flexible")]
                    c = int(res.count[ch, i])
                    assert res.idx[ch, i, :c].tolist() == want, (backend, ch, i)
        log(f"[16 streams] hop={hop} {backend}: 4 channels equal to the CPU run"
            + (f"; {2 * w} windows to the float64 oracle" if hop == STREAM_WINDOW else ""))

    assert mags.shape == (STREAM_CHANNELS, w, STREAM_WINDOW // 2) and freqs.shape == (4096,)
    with _one_cpu_thread():
        _, cpu_mags = streaming.spectrogram(x[:4], FS, STREAM_WINDOW, backend="pallas",
                                            device="cpu")
    scale = cpu_mags.amax(dim=-1, keepdim=True)
    assert bool(((mags[:4].cpu() - cpu_mags).abs() <= 4e-6 * scale).all()), "spectrogram vs CPU"
    h = WELCH_WINDOW // 2
    for backend, p in psd.items():
        assert p.shape == (STREAM_CHANNELS, h) and float(p[:, 0].abs().max()) == 0.0
        for ch in range(4):
            _, p_sp = scipy.signal.welch(x[ch].astype(np.float64), fs=FS,
                                         window=np.hanning(WELCH_WINDOW), nperseg=WELCH_WINDOW,
                                         noverlap=WELCH_WINDOW // 2, detrend="constant")
            np.testing.assert_allclose(p[ch, 1:h].cpu().numpy(), p_sp[1:h], rtol=2e-2)
    log(f"[16 streams] spectrogram [64, {w}, 4096] (backend='pallas') within 4e-6 of the row "
        f"maximum of the CPU run on 4 channels; welch_psd (both backends) within rtol 2e-2 of "
        f"scipy.signal.welch on 4 channels")

    for hop, backend in runs:
        sec = _wall_ms(lambda: streaming.analyze_stream(
            x, FS, STREAM_WINDOW, hop, mode="flexible", refine=True, backend=backend),
            runs=3, warmup=1) / 1e3
        n_win = results[hop, backend].count.numel()
        log(f"[16 times] analyze_stream hop={hop} backend={backend}: {n_win / sec:.1f} "
            f"windows/s ({sec * 1e3:.2f} ms for {n_win} windows from host memory, host wall, "
            f"median of 3; {card})")
    pipeline.reset_dynamic_state()
    return launches, err


def phase_cross_spectra(card: str) -> dict[str, int]:
    """``coherence_with_phase`` and ``cross_psd`` on 32 sensor pairs
    ``[32, 131072]`` at window 4096, against the CPU run and scipy.
    Returns the kernel launches (none: the complex front end is the
    four-step's ``torch.matmul`` calls)."""
    import scipy.signal

    rng = np.random.default_rng(2029)
    t = np.arange(STREAM_T) / FS
    f = rng.uniform(5.0, 200.0, (32, 1))
    x = (np.sin(2 * np.pi * f * t) + 0.5 * rng.standard_normal((32, STREAM_T))).astype(np.float32)
    y = (0.7 * np.sin(2 * np.pi * f * t - np.pi / 4)
         + 0.5 * rng.standard_normal((32, STREAM_T))).astype(np.float32)
    window, h = 4096, 2048
    _zero_counts()
    freqs, cxy, phase = streaming.coherence_with_phase(x, y, FS, window)
    fx, pxy = streaming.cross_psd(x, y, FS, window)
    torch.cuda.synchronize()
    launches = _counts()
    assert cxy.shape == phase.shape == (32, h) and pxy.shape == (32, h) and np.iscomplexobj(pxy)
    assert pxy.dtype == np.complex64 or pxy.dtype == np.complex128
    tone = np.rint(f[:, 0] * window / FS).astype(int)
    rows = np.arange(32)
    assert bool((cxy[rows, tone] > 0.95).all()), cxy[rows, tone]
    assert bool(((phase[rows, tone] + 45.0).abs() < 5.0).all()), phase[rows, tone]
    with _one_cpu_thread():
        _, c_cpu, ph_cpu = streaming.coherence_with_phase(x[:2], y[:2], FS, window, device="cpu")
        _, p_cpu = streaming.cross_psd(x[:2], y[:2], FS, window, device="cpu")
    np.testing.assert_allclose(cxy[:2].cpu().numpy(), c_cpu.numpy(), atol=1e-5)
    np.testing.assert_allclose(phase[rows[:2], tone[:2]].cpu().numpy(),
                               ph_cpu[rows[:2], tone[:2]].numpy(), atol=1e-3)
    np.testing.assert_allclose(pxy[:2], p_cpu, rtol=1e-5, atol=1e-6 * np.abs(p_cpu).max())
    for i in range(2):
        x64, y64 = x[i].astype(np.float64), y[i].astype(np.float64)
        kw = dict(fs=FS, window=np.hanning(window), nperseg=window, noverlap=window // 2,
                  detrend="constant")
        _, p_sp = scipy.signal.csd(x64, y64, **kw)
        _, c_sp = scipy.signal.coherence(x64, y64, **kw)
        b = tone[i]
        assert abs(abs(pxy[i, b]) - abs(p_sp[b])) <= 0.02 * abs(p_sp[b]), (i, pxy[i, b], p_sp[b])
        assert abs(np.angle(pxy[i, b]) - np.angle(p_sp[b])) <= 0.02, (i, pxy[i, b], p_sp[b])
        sm = lambda a: np.convolve(np.abs(a), np.ones(32) / 32, mode="valid")  # noqa: E731
        np.testing.assert_allclose(sm(pxy[i, 1:h]), sm(p_sp[1:h]), rtol=0.1)
        np.testing.assert_allclose(cxy[i, 1:h].cpu().numpy(), c_sp[1:h], atol=0.02)
    log(f"[17 cross spectra] 32 pairs [32, {STREAM_T}] window {window}: coherence > 0.95 and "
        f"phase -45 +- 5 degrees at every shared mode; 2 pairs equal to the CPU run and within "
        f"the JAX tests' tolerances of scipy.signal.csd / coherence; kernel launches {launches}")
    segs = 2 * 32 * ((STREAM_T - window) // (window // 2) + 1)
    sec = _wall_ms(lambda: streaming.coherence_with_phase(x, y, FS, window), runs=3,
                   warmup=1) / 1e3
    log(f"[17 times] coherence_with_phase: {segs / sec:.1f} segments/s ({sec * 1e3:.2f} ms for "
        f"{segs} segments of {window} from host memory, host wall, median of 3; {card})")
    return launches


@contextlib.contextmanager
def _no_sync():
    """Fail on any operation that makes the host wait for the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_pipelined(corpora: dict[str, np.ndarray], oracle,
                    card: str) -> tuple[dict[str, int], dict[str, float]]:
    """``analyze_epochs_pipelined``: 16 noisy [2048, 4096] epochs at depth 1
    and 4, and 64 single-window epochs at depth 4 of cfg2 windows (N=4096,
    flexible, refine) and cfg1 windows (N=1024, rigid), against sequential
    ``analyze_epoch``; every dispatch in the depth-4 runs goes through
    ``analyze_epoch`` with the card's synchronisation debug mode set to
    "error".  Returns launches and errors."""
    rng = np.random.default_rng(2030)
    base = corpora["noisy"]
    epochs = [base[rng.permutation(BATCH)]
              + (0.05 * rng.standard_normal(base.shape)).astype(np.float32) for _ in range(16)]
    # BASELINE cfg2 and cfg1 windows (the two tones of bench.py), 64 noise draws each.
    singles = {"flexible": list(clean_batch(64, N_FFT)[:, None]),
               "rigid": list(clean_batch(64, 1024)[:, None])}
    kws = {"flexible": dict(refine=True), "rigid": dict()}

    def sequential(eps, mode, **kw):
        pipeline.reset_dynamic_state()
        return [pipeline.analyze_epoch(e, FS, mode=mode, **kw) for e in eps]

    def unsynced(samples, fs, **kw):
        with _no_sync():
            return pipeline.analyze_epoch(samples, fs, **kw)

    seq = sequential(epochs, "flexible", refine=True)
    seq_single = {m: sequential(eps, m, **kws[m]) for m, eps in singles.items()}
    out = {}
    _zero_counts()
    with _Taps() as taps:
        for depth in (1, 4):
            pipeline.reset_dynamic_state()
            out[depth] = list(streaming.analyze_epochs_pipelined(
                epochs, FS, depth=depth, refine=True, analyze=unsynced if depth == 4 else
                pipeline.analyze_epoch))
            log(f"[18 pipelined] 16 noisy epochs at depth {depth}: dynamic_state "
                f"{pipeline.dynamic_state()['budget']}")
        out_single = {}
        for mode, eps in singles.items():
            pipeline.reset_dynamic_state()
            out_single[mode] = list(streaming.analyze_epochs_pipelined(
                eps, FS, depth=4, mode=mode, analyze=unsynced, **kws[mode]))
        torch.cuda.synchronize()
    launches = _counts()
    log(f"[18 pipelined] kernel launches on the pipelined paths: {launches}")
    for key in ("prominence_select_scan", "lowlat_flexible", "lowlat_rigid"):
        assert launches[key] > 0, (key, launches)
    err = taps.check("18 pipelined")
    for a in (epochs[0], singles["flexible"][0]):  # pinned, and pageable (small)
        with _no_sync():
            placed = pipeline._placed(a, None, torch.float32)
        assert torch.equal(placed.cpu(), torch.from_numpy(a))

    exact = DECISIONS + ("freq", "mag", "prominence", "damping", "q_factor", "refined_freq")
    for label, got_all, want_all in (
            [(f"noisy depth {d}", out[d], seq) for d in (1, 4)]
            + [(f"{m} single windows depth 4", out_single[m], seq_single[m]) for m in singles]):
        assert len(got_all) == len(want_all)
        for i, (got, want) in enumerate(zip(got_all, want_all)):
            _assert_same(got, want, DECISIONS, [(f, 1e-4, 1e-5) for f in exact[4:]],
                         f"pipelined {label} epoch {i} vs sequential")
        log(f"[18 pipelined] {label}: every epoch's decisions equal sequential analyze_epoch")
    for i in (0, 1):
        cpu = _cpu_reference(torch.from_numpy(epochs[i]), FS, refine=True, lowlat="never",
                             max_candidates=int(out[4][i].n_required.max()))
        _assert_same(out[4][i], cpu, ("count", "idx"), (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-5)),
                     f"pipelined epoch {i} vs CPU")
    for i in range(32):
        want = [p["idx"] for p in oracle.oracle_analyze(epochs[0][i].astype(np.float64), FS,
                                                        "flexible")]
        c = int(out[4][0].count[i])
        assert out[4][0].idx[i, :c].tolist() == want, i
    log("[18 pipelined] epochs 0 and 1 equal to the CPU run, 32 windows of epoch 0 to the "
        "float64 oracle; an epoch's placement and every depth-4 dispatch ran with no "
        "synchronisation")

    rates = {1: [], 4: []}
    for depth in (1, 4, 4, 1):
        sec = _wall_ms(lambda: list(streaming.analyze_epochs_pipelined(
            epochs, FS, depth=depth, refine=True)), runs=3, warmup=1) / 1e3
        rates[depth].append(len(epochs) * BATCH / sec)
    single_rates = {1: [], 4: []}
    for depth in (1, 4, 4, 1):
        sec = _wall_ms(lambda: list(streaming.analyze_epochs_pipelined(
            singles["flexible"], FS, depth=depth, refine=True)), runs=3, warmup=1) / 1e3
        single_rates[depth].append(len(singles["flexible"]) / sec)
    log(f"[18 times] pipelined 16 noisy epochs B={BATCH} N={N_FFT}, windows/s: depth 1 "
        f"{' / '.join(f'{r:.1f}' for r in rates[1])}, depth 4 "
        f"{' / '.join(f'{r:.1f}' for r in rates[4])}; 64 cfg2 single windows, windows/s: "
        f"depth 1 {' / '.join(f'{r:.1f}' for r in single_rates[1])}, depth 4 "
        f"{' / '.join(f'{r:.1f}' for r in single_rates[4])} (host wall, median of 3, "
        f"1-4-4-1 order; {card})")
    phase_placement(card)
    pipeline.reset_dynamic_state()
    return launches, err


def phase_placement(card: str) -> None:
    """How a host array reaches the card, by size: pinned then copied, or
    copied from pageable memory, both ``non_blocking``, against
    ``pipeline._from_host`` (pinned past ``_PAGEABLE_MAX_BYTES``).  Host wall
    with a synchronize, interleaved; then the host time of each call while
    the card is busy with ~10 ms of queued work, which shows whether the
    call waits for the card."""
    places = {
        "pinned": lambda a: torch.as_tensor(a).pin_memory().to("cuda", non_blocking=True),
        "pageable": lambda a: torch.as_tensor(a).to("cuda", non_blocking=True),
        "_from_host": lambda a: pipeline._from_host(a, "cuda"),
    }
    rng = np.random.default_rng(2031)
    for n in (4096, 1 << 16, 1 << 18, 1 << 19, 1 << 20, BATCH * N_FFT):
        a = rng.standard_normal(n).astype(np.float32)
        ms = {k: [] for k in places}
        for k in ("pinned", "pageable", "_from_host", "_from_host", "pageable", "pinned"):
            ms[k].append(_wall_ms(lambda: places[k](a), runs=20, warmup=2))
        busy = {}
        for k, place in places.items():
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                torch.cuda._sleep(20_000_000)
                t0 = time.perf_counter()
                out = place(a)
                times.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            assert torch.equal(out.cpu(), torch.from_numpy(a)), k
            busy[k] = statistics.median(times)
        log(f"[18 placement] {n * 4} bytes float32: "
            + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in ms.items())
            + " (host wall with synchronize, median of 20); host time of the call behind "
            "~10 ms of queued card work: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in busy.items())
            + f" (median of 5; {card})")


# ---------------------------------------------------------------- field ops and modal analysis

#: The gateway's severity batches: ``benchmarks/scale_soak.py``'s 256 sensors
#: x 3 axes, padded to 1024 rows (``service.py``'s pow2 row pad), at each
#: output data rate's record length.
SEVERITY_ROWS = 1024
SEVERITY_BATCHES = ((500.0, 4096), (1000.0, 8192))
#: Shock transients: the gateway's 0xC1 records, 4096 samples at 1000 Hz.
SHOCK_FS, SHOCK_N, SHOCK_BATCH = 1000.0, 4096, 256
#: Modal arrays: 16384 samples at 500 Hz, the gateway's FDD window.
MODAL_FS, MODAL_T, FDD_WINDOW = 500.0, 16384, 1024
MODAL_SENSORS = (32, 256)
MODAL_FREQS, MODAL_ZETAS = (12.3, 31.7, 58.9), (0.01, 0.015, 0.02)
#: Integration's bound against float64, by order, in units of each row's
#: scale: float32 arithmetic reaches ~2e-5 on displacement of these batches,
#: in the JAX package too (``tests/test_torch_field_ops.py``).
INTEGRATE_BOUND = {1: 1e-5, 2: 5e-5}


def _device_busy(fn) -> tuple[float, int]:
    """Device busy time in ms (the durations of the kernels and copies the
    card ran, one stream) and the number of kernels, over one call of
    ``fn`` after a warm-up call, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sum(1 for e in events if not e.name.startswith(("Memcpy", "Memset")))
    return sum(e.device_time for e in events) / 1e3, kernels


def _times(label: str, fn, card: str, runs: int = 5) -> float:
    """Logs and returns the host wall of one call of ``fn`` (median of
    ``runs``, ending in a synchronize), beside its device busy time."""
    wall = _wall_ms(fn, runs=runs, warmup=1)
    busy, kernels = _device_busy(fn)
    log(f"[times] {label}: host wall {wall:.3f} ms (median of {runs}), device busy "
        f"{busy:.3f} ms in {kernels} kernels (torch.profiler); {card}")
    return wall


def severity_batch(fs: float, n: int, seed: int) -> np.ndarray:
    """``[1024, n]`` float32 accelerations in g: three tones a row at 5..0.4 fs
    (0.01..0.5 g), a DC offset of -1..1 g and 0.01 g of noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = rng.uniform(-1.0, 1.0, (SEVERITY_ROWS, 1)) + 0.01 * rng.standard_normal((SEVERITY_ROWS, n))
    for _ in range(3):
        f = rng.uniform(5.0, 0.4 * fs, (SEVERITY_ROWS, 1))
        x += rng.uniform(0.01, 0.5, (SEVERITY_ROWS, 1)) * np.sin(
            2 * np.pi * f * t + rng.uniform(0, 2 * np.pi, (SEVERITY_ROWS, 1)))
    return x.astype(np.float32)


def integrate_oracle(x: np.ndarray, fs: float, order: int) -> np.ndarray:
    """The integration in float64 numpy (``tests/test_integrate.py``'s
    oracle): mean removed, Tukey(0.3) taper, raised-cosine gate from 8 bins
    to 16, ``(-i)^order / w^order``."""
    import scipy.signal

    n = x.shape[-1]
    x64 = x.astype(np.float64)
    spec = np.fft.rfft((x64 - x64.mean(-1, keepdims=True)) * scipy.signal.windows.tukey(n, 0.3))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    w = 2 * np.pi * freqs
    f_hp = 8.0 * fs / n
    gate = np.where(freqs < f_hp, 0.0, 0.5 - 0.5 * np.cos(np.pi * np.clip((freqs - f_hp) / f_hp,
                                                                          0.0, 1.0)))
    return np.fft.irfft(spec * (-1j) ** order * gate / np.where(w > 0, w, 1.0) ** order, n=n)


def severity_oracle(x: np.ndarray, fs: float, band: tuple[float, float]) -> np.ndarray:
    """Band-limited velocity RMS in float64 numpy, by Parseval."""
    n = x.shape[-1]
    x64 = x.astype(np.float64)
    spec = np.fft.rfft(x64 - x64.mean(-1, keepdims=True))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    w = 2 * np.pi * freqs
    inband = (freqs >= band[0]) & (freqs <= min(band[1], fs / 2)) & (w > 0)
    weight = np.full(n // 2 + 1, 2.0)
    weight[0] = weight[-1] = 1.0
    v2 = np.where(inband, np.abs(spec) ** 2 / np.where(w > 0, w, 1.0) ** 2, 0.0)
    return np.sqrt((v2 * weight).sum(-1) / (n * n))


def shock_transients(b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``[b, 4096]`` float32 free decays at 1000 Hz (f0 20..150 Hz, zeta
    0.005..0.05, 0.5..5 g, 0.5% noise) with their f0 and zeta."""
    rng = np.random.default_rng(2032)
    t = np.arange(SHOCK_N) / SHOCK_FS
    f0 = rng.uniform(20.0, 150.0, b)
    zeta = rng.uniform(0.005, 0.05, b)
    amp = rng.uniform(0.5, 5.0, (b, 1))
    w0 = 2 * np.pi * f0[:, None]
    x = amp * np.exp(-zeta[:, None] * w0 * t) * np.sin(
        w0 * np.sqrt(1 - zeta[:, None] ** 2) * t + rng.uniform(0, 2 * np.pi, (b, 1)))
    x += 0.005 * amp * rng.standard_normal((b, SHOCK_N))
    return x.astype(np.float32), f0, zeta


def srs_oracle(x: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """``[3, b, F]`` maximax/positive/negative of the float64
    ``scipy.signal.lfilter`` Smallwood bank, residual included."""
    import scipy.signal

    b, a = srs.smallwood_coefficients(freqs, SHOCK_FS)
    xp = np.concatenate([x.astype(np.float64),
                         np.zeros((x.shape[0], int(np.ceil(SHOCK_FS / freqs.min()))))], axis=-1)
    y = np.stack([scipy.signal.lfilter(b[:, i], a[:, i], xp, axis=-1) for i in range(len(freqs))],
                 axis=-1)
    return np.stack([np.abs(y).max(1), y.max(1), y.min(1)])


def phase_field_ops(card: str) -> None:
    """Integration, severity, ring-down, SRS and resampling at the gateway's
    sizes, each against the port's CPU run (one intra-op thread) and a
    float64 oracle; no kernel of the port launches."""
    import scipy.signal

    _zero_counts()
    band = (10.0, 1000.0)
    for i, (fs, n) in enumerate(SEVERITY_BATCHES):
        x = severity_batch(fs, n, seed=2033 + i)
        rms = integrate.velocity_rms(x, fs, band=band)
        assert rms.device.type == "cuda" and rms.shape == (SEVERITY_ROWS,)
        with _one_cpu_thread():
            cpu = integrate.velocity_rms(x, fs, band=band, device="cpu")
        ref = severity_oracle(x, fs, band)
        e_cpu = float(((rms.cpu() - cpu).abs() / cpu).max())
        e_ref = float(np.max(np.abs(rms.cpu().numpy() - ref) / ref))
        assert e_cpu <= 1e-5 and e_ref <= 1e-5, (fs, e_cpu, e_ref)
        log(f"[19 field ops] velocity_rms [{SEVERITY_ROWS}, {n}] at {fs:g} Hz, band {band}: "
            f"max rel diff {e_cpu:.3g} from the CPU run, {e_ref:.3g} from float64 (bound 1e-5)")
        _times(f"velocity_rms [{SEVERITY_ROWS}, {n}]", lambda: integrate.velocity_rms(
            x, fs, band=band), card)
        for order in (1, 2):
            got = integrate.integrate_acceleration(x, fs, order=order)
            with _one_cpu_thread():
                cpu = integrate.integrate_acceleration(x, fs, order=order, device="cpu")
            ref = integrate_oracle(x, fs, order)
            scale = np.abs(ref).max(-1)
            got = got.cpu().numpy()
            e_cpu = float(np.max(np.abs(got - cpu.numpy()).max(-1) / scale))
            e_ref = float(np.max(np.abs(got - ref).max(-1) / scale))
            bound = INTEGRATE_BOUND[order]
            assert e_cpu <= bound and e_ref <= bound, (fs, order, e_cpu, e_ref)
            log(f"[19 field ops] integrate_acceleration order {order} [{SEVERITY_ROWS}, {n}] at "
                f"{fs:g} Hz: max diff {e_cpu:.3g} of each row's scale from the CPU run, "
                f"{e_ref:.3g} from float64 (bound {bound:g})")
            _times(f"integrate_acceleration order {order} [{SEVERITY_ROWS}, {n}]",
                   lambda: integrate.integrate_acceleration(x, fs, order=order), card)

    x, f0, zeta = shock_transients(SHOCK_BATCH)
    for rows in (slice(0, 1), slice(None)):
        xs, fs0 = x[rows], f0[rows]
        one = xs.shape[0] == 1
        got = ringdown.ringdown_damping(xs[0] if one else xs, SHOCK_FS, float(fs0[0]) if one
                                        else fs0)
        with _one_cpu_thread():
            cpu = ringdown.ringdown_damping(xs[0] if one else xs, SHOCK_FS, float(fs0[0]) if one
                                            else fs0, device="cpu")
        got_h = np.atleast_1d(got.cpu().numpy())
        assert got.device.type == "cuda" and not np.isnan(got_h).any()
        np.testing.assert_allclose(got_h, np.atleast_1d(cpu.numpy()), rtol=1e-4)
        e_true = float(np.max(np.abs(got_h - zeta[rows]) / zeta[rows]))
        # The JAX tests' bounds are 0.10-0.25; near zeta 0.05 the +-20% band
        # clips the line's skirts and the log decrement reads high.
        assert e_true <= 0.15, e_true
        log(f"[19 field ops] ringdown_damping {list(xs.shape)} at {SHOCK_FS:g} Hz: within rtol "
            f"1e-4 of the CPU run; max rel error from the true zeta {e_true:.3g} (bound 0.15)")
        _times(f"ringdown_damping {list(xs.shape)}", lambda: ringdown.ringdown_damping(
            xs, SHOCK_FS, fs0), card)

        res = srs.shock_response_spectrum(xs[0] if one else xs, SHOCK_FS)
        with _one_cpu_thread():
            cpu = srs.shock_response_spectrum(xs[0] if one else xs, SHOCK_FS, device="cpu")
        ref = srs_oracle(xs, res.freqs)
        for k, f in enumerate(("maximax", "positive", "negative")):
            g = np.atleast_2d(getattr(res, f))
            assert g.dtype == np.float32 and g.shape == ref[k].shape, f
            top = np.abs(ref[0]).max()
            np.testing.assert_allclose(g, np.atleast_2d(getattr(cpu, f)), rtol=5e-5,
                                       atol=1e-6 * top, err_msg=f"{f} vs CPU")
            np.testing.assert_allclose(g, ref[k], rtol=5e-5, atol=1e-6 * top,
                                       err_msg=f"{f} vs lfilter")
        log(f"[19 field ops] shock_response_spectrum {list(xs.shape)}, {len(res.freqs)} "
            f"oscillators: maximax/positive/negative within rtol 5e-5 of the CPU run and of "
            f"float64 scipy.signal.lfilter")
        _times(f"shock_response_spectrum {list(xs.shape)}", lambda: srs.shock_response_spectrum(
            xs, SHOCK_FS), card)

    rng = np.random.default_rng(2034)
    rec = rng.standard_normal((SHOCK_BATCH, 8192)).astype(np.float32)
    up, down = resample.rational_factors(100.0, 62.5)
    assert (up, down) == (5, 8)
    # The gateway decimates one float64 record at a time (``service.py``'s modal merge).
    cases = [("decimate q=2, one record", rec[0].astype(np.float64), 1, 2)] + [
        (f"decimate q={q}", rec, 1, q) for q in (2, 4, 8)] + [
        ("resample_rational 100 -> 62.5 Hz", rec, up, down)]
    for label, xr, u, d in cases:
        def run(dev=None):
            if u == 1:
                return resample.decimate(xr, d, device=dev)
            return resample.resample_rational(xr, u, d, device=dev)
        got = run()
        with _one_cpu_thread():
            cpu = run("cpu")
        taps = (resample.design_decimation_taps(d) if u == 1
                else resample._rational_taps(u, d, 12, 0.8) / u)
        ref = scipy.signal.resample_poly(xr.astype(np.float64), u, d, axis=-1, window=taps)
        assert got.dtype == np.float64 and got.shape == ref.shape, label
        e_ref = float(np.abs(got - ref).max() / np.abs(ref).max())
        e_cpu = float(np.abs(got - cpu).max() / np.abs(ref).max())
        assert e_ref < 3e-6 and e_cpu < 3e-6, (label, e_ref, e_cpu)
        log(f"[19 field ops] {label} {list(xr.shape)} -> {list(got.shape)}: {e_ref:.3g} of the "
            f"peak from float64 scipy.signal.resample_poly, {e_cpu:.3g} from the CPU run (bound "
            f"3e-6: IEEE float32 convolution)")
        _times(f"{label} {list(xr.shape)}", run, card)
    launches = _counts()
    assert not any(launches.values()), launches
    log(f"[19 field ops] kernel launches on the field ops: {launches} (none: torch ops only)")


def modal_array(s: int) -> tuple[np.ndarray, np.ndarray]:
    """``[s, 16384]`` float32 at 500 Hz: modes at 12.3, 31.7 and 58.9 Hz
    (zeta 1, 1.5, 2 %) with bending-like shapes along a line of ``s``
    sensors, the higher modes scaled by 2 and 4; returns the records and
    the unit-scale shapes."""
    shapes = np.array([np.sin(np.pi * (m + 1) * (np.arange(s) + 1) / (s + 1)) for m in range(3)])
    x = modal_records(shapes * np.array([1.0, 2.0, 4.0])[:, None], MODAL_FREQS, MODAL_ZETAS,
                      MODAL_FS, MODAL_T / MODAL_FS, seed=9)
    return x, shapes


def phase_fdd(arrays: dict, card: str) -> tuple[dict[str, int], dict[str, float]]:
    """``fdd(records, 500, 1024, efdd=True, harmonics=True)``, the gateway's
    call, on the ``[32, 16384]`` and ``[256, 16384]`` arrays: the select+scan
    kernel launches (no other kernel), each call held against its plain
    twin; decisions equal the CPU run; shapes against the known ones; s1/s2
    against float64 ``eigh``; ``ModalTracker.update`` on the result.
    Returns launches and errors."""
    results = {}
    _zero_counts()
    with _Taps() as taps:
        for s, (x, _) in arrays.items():
            results[s] = modal.fdd(x, MODAL_FS, FDD_WINDOW, efdd=True, harmonics=True)
    launches = _counts()
    log(f"[20 fdd] kernel launches on the FDD path: {launches}")
    assert launches["prominence_select_scan"] == len(arrays), launches
    assert sum(launches.values()) == len(arrays), launches
    err = taps.check("20 fdd")

    h = FDD_WINDOW // 2
    for s, (x, shapes) in arrays.items():
        res = results[s]
        with _one_cpu_thread():
            cpu = modal.fdd(x, MODAL_FS, FDD_WINDOW, efdd=True, harmonics=True, device="cpu")
        for f in ("count", "idx", "freq", "damping"):
            np.testing.assert_array_equal(getattr(res, f), getattr(cpu, f), err_msg=f"S={s} {f}")
        top = cpu.sv1.max()
        e_sv = float(max(np.abs(res.sv1 - cpu.sv1).max(), np.abs(res.sv2 - cpu.sv2).max()) / top)
        assert e_sv <= 5e-6, (s, e_sv)
        n = int(res.count)
        assert n == 3, (s, res.freq)
        assert np.abs(res.freq[:n] - np.array(MODAL_FREQS)).max() <= 2 * MODAL_FS / FDD_WINDOW
        mac = modal.modal_assurance(res.shapes()[:n], shapes).diagonal()
        assert mac.min() >= 0.99, (s, mac)
        assert np.isfinite(res.damping_efdd[:n]).all() and (res.kurtosis[:n] > 2.5).all()
        _, gr, gi = modal.csd_matrix(x, MODAL_FS, FDD_WINDOW)
        bins = np.arange(1, h) if s <= 32 else np.unique(np.r_[np.arange(1, h, 8), res.idx[:n]])
        g = (gr.cpu().numpy().astype(np.float64) + 1j * gi.cpu().numpy().astype(np.float64))[bins]
        w, v = np.linalg.eigh(g)
        e_s1 = float(np.abs(res.sv1[bins] - w[:, -1]).max() / w[:, -1].max())
        assert e_s1 < 2e-3, (s, e_s1)
        np.testing.assert_allclose(res.sv2[bins], w[:, -2], rtol=5e-3, atol=1e-3 * w[:, -1].max())
        for i in range(n):
            ve = v[int(np.flatnonzero(bins == res.idx[i])[0]), :, -1]
            assert abs(np.vdot(res.shapes()[i], ve)) ** 2 / np.vdot(ve, ve).real > 0.995, (s, i)
        tracker = modal.ModalTracker()
        born = tracker.update(res, t=0.0)
        again = tracker.update(res, t=60.0)
        assert len(born) == n and sorted(t.track_id for t in again) == sorted(
            t.track_id for t in born)
        assert min(t.macs[-1] for t in again) > 0.9999 and not tracker.shape_alerts()
        log(f"[20 fdd] S={s}: modes {np.round(res.freq[:n], 4).tolist()} Hz, half-power "
            f"damping {np.round(res.damping[:n], 2).tolist()} %, EFDD "
            f"{np.round(res.damping_efdd[:n], 3).tolist()} %, "
            f"kurtosis {np.round(res.kurtosis[:n], 3).tolist()}; count/idx/freq/damping equal to "
            f"the CPU run, s1/s2 within {e_sv:.3g} of max s1 from it (bound 5e-6); shapes MAC "
            f"{np.round(mac, 6).tolist()} against the known ones (bound 0.99); s1 within "
            f"{e_s1:.3g} of float64 eigh on {len(bins)} bins (bound 2e-3); ModalTracker matched "
            f"its {n} tracks")

    for s, (x, _) in arrays.items():
        xt = torch.from_numpy(x).cuda()
        _times(f"fdd S={s}: csd_matrix [{s}, {MODAL_T}] -> [{h}, {s}, {s}]",
               lambda: modal.csd_matrix(xt, MODAL_FS, FDD_WINDOW), card)
        freqs, gr, gi = modal.csd_matrix(xt, MODAL_FS, FDD_WINDOW)
        _times(f"fdd S={s}: sv_spectra, 2 x 60 power-iteration steps", lambda: modal.sv_spectra(
            gr, gi), card)
        s1, s2, vr, vi = modal.sv_spectra(gr, gi)
        fs_b = torch.full((1,), MODAL_FS, device=s1.device)

        def detect():
            # fdd's detector call and its one host copy per dtype.
            det = pipeline._detect_from_mags(
                torch.sqrt(torch.clamp(s1, min=0.0))[None, :], fs_b, n_fft=FDD_WINDOW,
                mode="flexible", k=pipeline.default_k("flexible"),
                max_candidates=pipeline.default_max_candidates(FDD_WINDOW), refine=False)
            return batching._host_copies([*det, freqs, s1, s2, vr, vi])

        _times(f"fdd S={s}: detect on sqrt(s1) [1, {h}] + host copies", detect, card)
        res = results[s]
        host = [t.cpu().numpy().astype(np.float64) for t in (s1, vr, vi)]
        _times(f"fdd S={s}: EFDD on the host, {int(res.count)} modes", lambda: [
            modal._efdd_zeta(*host, int(i), MODAL_FS, FDD_WINDOW)
            for i in res.idx[: int(res.count)]], card)
        _times(f"fdd S={s}: harmonic_indicator, {int(res.count)} modes",
               lambda: modal.harmonic_indicator(xt, MODAL_FS, res.freq[: int(res.count)],
                                                window=FDD_WINDOW), card)
        _times(f"fdd S={s}: the whole fdd call, from host memory",
               lambda: modal.fdd(x, MODAL_FS, FDD_WINDOW, efdd=True, harmonics=True), card)
    return launches, err


def _correlation_batched(records: torch.Tensor, n_lags: int) -> torch.Tensor:
    """The correlation blocks as one batched product over an ``unfold`` view
    ``[L, S, T0]`` (which the product copies), for comparison with the
    port's one product a lag."""
    t0 = records.shape[-1] - n_lags + 1
    x = records - records.mean(dim=-1, keepdim=True)
    with ieee_fp32_matmul():
        r = torch.matmul(x.unfold(-1, t0, 1).transpose(0, 1), x[:, :t0].T)
    return r / t0


def phase_ssi(arrays: dict, card: str) -> None:
    """``ssi(records, 500, i=20)``, the gateway's call, on the ``[32, 16384]``
    array against the CPU run and the known modes; the correlation blocks
    one product a lag against one batched product, at S = 32 and 256."""
    x, shapes = arrays[32]
    _zero_counts()
    res = ssi.ssi(x, MODAL_FS, i=20)
    launches = _counts()
    assert not any(launches.values()), launches
    with _one_cpu_thread():
        cpu = ssi.ssi(x, MODAL_FS, i=20, device="cpu")
    assert res.count == cpu.count == 3, (res.freqs(), cpu.freqs())
    for a, b, f, z, shape in zip(res.modes, cpu.modes, MODAL_FREQS, MODAL_ZETAS, shapes):
        assert abs(a.n_orders - b.n_orders) <= 1
        assert abs(a.freq - b.freq) <= 2e-5 * b.freq + b.freq_std, (a.freq, b.freq)
        assert abs(a.damping - b.damping) <= 1e-2 * b.damping + b.damping_std, (a, b)
        assert modal.modal_assurance(a.shape, b.shape)[0, 0] >= 0.999
        assert abs(a.freq - f) / f < 5e-3 and abs(a.damping - 100 * z) / (100 * z) < 0.25
        assert modal.modal_assurance(a.shape, shape)[0, 0] > 0.99
    log(f"[21 ssi] S=32: modes {[round(m.freq, 4) for m in res.modes]} Hz, damping "
        f"{[round(m.damping, 4) for m in res.modes]} % (true {[100 * z for z in MODAL_ZETAS]}), "
        f"orders {[m.n_orders for m in res.modes]}; the CPU run's modes (freq within 2e-5 + the "
        f"cluster spread, MAC >= 0.999) and the known ones (freq 0.5%, damping 25%, MAC > 0.99); "
        f"kernel launches {launches}")

    n_lags = 40
    for s, (xs, _) in arrays.items():
        xt = torch.from_numpy(xs).cuda()
        per_lag = ssi._correlation_impl(xt, n_lags=n_lags, detrend="mean")
        batched = _correlation_batched(xt, n_lags)
        e = float((per_lag - batched).abs().max() / per_lag.abs().max())
        assert e < 1e-5, (s, e)
        ms = {"per lag": [], "batched": []}
        for name in ("per lag", "batched", "batched", "per lag"):
            fn = ((lambda: ssi._correlation_impl(xt, n_lags=n_lags, detrend="mean"))
                  if name == "per lag" else (lambda: _correlation_batched(xt, n_lags)))
            ms[name].append(event_ms(fn, runs=10))
        log(f"[21 times] correlation blocks [{s}, {MODAL_T}] x {n_lags} lags: one product a lag "
            f"{' / '.join(f'{t:.4f}' for t in ms['per lag'])} ms, one batched product over the "
            f"unfold view {' / '.join(f'{t:.4f}' for t in ms['batched'])} ms (CUDA events, "
            f"median of 10, mirrored order; the two within {e:.2g} of each other); {card}")
    blocks = ssi.correlation_blocks(x, n_lags)
    _times(f"ssi S=32: correlation_blocks [32, {MODAL_T}] x {n_lags} lags, from host memory",
           lambda: ssi.correlation_blocks(x, n_lags), card)
    ident = _wall_ms(lambda: ssi.ssi(x, MODAL_FS, i=20, blocks=blocks), runs=5, warmup=1)
    whole = _wall_ms(lambda: ssi.ssi(x, MODAL_FS, i=20), runs=5, warmup=1)
    log(f"[21 times] ssi S=32: host identification (ssi on given blocks) {ident:.3f} ms, the "
        f"whole call {whole:.3f} ms (host wall, median of 5; {card})")


# ---------------------------------------------------------------- the gateway

#: The gateway cell: ``benchmarks/scale_soak.py``'s 256 sensors, with the
#: full-feature configuration and traffic of ``benchmarks/endurance.py``
#: (257-279 and 298-345), 3 epochs compared with the CPU run.
GATEWAY_SENSORS, GATEWAY_EPOCHS = 256, 3


@contextlib.contextmanager
def _ssi_results():
    """Records every ``ssi`` result while active (the gateway imports
    ``ssi`` from its module at call time)."""
    real, got = ssi.ssi, []

    def tap(*args, **kwargs):
        res = real(*args, **kwargs)
        got.append(res)
        return res

    ssi.ssi = tap
    try:
        yield got
    finally:
        ssi.ssi = real


def _assert_ssi_close(got, want, where: str) -> None:
    """``tests/test_torch_ssi.py``'s rule: the same modes, ``n_orders``
    within 1, frequencies within 2e-5 relative plus the cluster spread,
    dampings within 1e-2 relative plus theirs, shapes at MAC >= 0.9999."""
    assert got.count == want.count, (where, got.freqs(), want.freqs())
    for a, b in zip(got.modes, want.modes):
        assert abs(a.n_orders - b.n_orders) <= 1, where
        assert abs(a.freq - b.freq) <= 2e-5 * b.freq + b.freq_std, (where, a.freq, b.freq)
        assert abs(a.damping - b.damping) <= 1e-2 * b.damping + b.damping_std, \
            (where, a.damping, b.damping)
        assert modal.modal_assurance(a.shape, b.shape)[0, 0] >= 0.9999, where
        assert abs(a.mpc - b.mpc) <= 1e-4, where
    np.testing.assert_allclose(got.hankel_sv, want.hankel_sv, rtol=0,
                               atol=1e-5 * want.hankel_sv.max(), err_msg=where)
    np.testing.assert_array_equal(got.orders, want.orders, err_msg=where)


def _gateway_run(gp, root: str, epochs, device: str) -> tuple[object, list, list]:
    """Drives the full-feature gateway over ``epochs`` (traffic, heartbeats)
    on ``device``; returns the still running side, per-epoch figures and
    the SSI results."""
    side = gp.Side("apda_fft_tpu_torch", root, flush_mode="on_sync",
                   gateway_extra=gp.FULL_FEATURE, device=device)
    on_card = torch.device(device).type == "cuda"
    stats = []
    with _ssi_results() as ssi_res:
        for traffic, beat in epochs:
            b1, n_hist = detector_cuda.launches, len(side.history())
            t0 = time.perf_counter()
            packets = side.feed(traffic)
            t_ingest = time.perf_counter() - t0
            analysed = len(side.svc.pending_analysis)
            packets += side.feed(beat)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            new = side.history()[n_hist:]
            stats.append({
                "packets": packets, "analysed": analysed, "wall_s": wall,
                "ingest_msamp_s": gp.samples_carried(traffic) / t_ingest / 1e6,
                "b1_launches": detector_cuda.launches - b1,
                "fdd_lines": sum("[FDD]" in ln for ln in new),
                "ssi_lines": sum("[SSI]" in ln for ln in new)})
    return side, stats, ssi_res


def phase_gateway(card: str) -> tuple[dict[str, int], dict[str, float]]:
    """The port's ``GatewayService`` on the card over the 256-sensor
    full-feature configuration and traffic, 3 epochs, every B1 call tapped
    and held against its plain twin; the same packets through the port on
    the CPU (one intra-op thread) give the same decisions; one more epoch on
    the card under ``torch.profiler``; then ``python -m
    apda_fft_tpu_torch.gateway --simulate`` on the card.  Returns launches
    and errors."""
    import tempfile

    from apda_fft_tpu_torch.io import native

    assert native.available(), "the native ingest did not build on the card's host"
    gp = _load_module("apda_gateway_parity", "test_torch_gateway_parity.py")
    port = "apda_fft_tpu_torch"
    macs = [f"0013a20041e7{i:04x}" for i in range(GATEWAY_SENSORS)]
    rng = np.random.default_rng(2035)
    mix: dict = {}
    epochs = [(gp.full_feature_epoch(port, macs, e, rng, seed=1, counts=mix),
              gp.heartbeats(port, macs)) for e in range(GATEWAY_EPOCHS + 1)]
    log(f"[22 gateway] {GATEWAY_SENSORS} sensors, {GATEWAY_EPOCHS} epochs + 1 profiled, "
        f"traffic mix {mix}; native ingest {native._library_path()}")
    with tempfile.TemporaryDirectory(prefix="apda_gw_") as root:
        _zero_counts()
        with _Taps() as taps:
            card_side, stats, card_ssi = _gateway_run(gp, os.path.join(root, "card"),
                                                      epochs[:GATEWAY_EPOCHS], "cuda")
            launches = _counts()
            log(f"[22 gateway] kernel launches on the gateway path: {launches}")
            assert launches["prominence_select_scan"] > 0, "the gateway never launched B1"
            assert sum(launches.values()) == launches["prominence_select_scan"], launches
            err = taps.check("22 gateway")
        with _one_cpu_thread():
            cpu_side, cpu_stats, cpu_ssi = _gateway_run(gp, os.path.join(root, "cpu"),
                                                        epochs[:GATEWAY_EPOCHS], "cpu")
            cpu_s = cpu_side.surface()
            cpu_side.svc.stop()
        card_s = card_side.surface()
        gp.assert_same_surface(card_s, cpu_s, "gateway card vs CPU", ssi_rule=True)
        assert len(card_ssi) == len(cpu_ssi), (len(card_ssi), len(cpu_ssi))
        for i, (a, b) in enumerate(zip(card_ssi, cpu_ssi)):
            _assert_ssi_close(a, b, f"gateway ssi call {i}")
        hist = card_s["history"]
        for needle in ("Peaks:", "Missing packets", "Anomalous closure", "Shock SRS:",
                       "Vibration severity", "[FDD]", "[SSI]", "decimated"):
            assert any(needle in ln for ln in hist), needle
        log(f"[22 gateway] card run equal to the CPU run (one intra-op thread): history "
            f"({len(hist)} lines, self-metrics masked), fft_results, {len(card_s['ftp'])} "
            f"uploads, {len(card_s['api'])} API payloads, drift and modal state; "
            f"{len(card_ssi)} SSI results under tests/test_torch_ssi.py's rule")
        for e, st in enumerate(stats):
            log(f"[22 gateway] epoch {e}: {st['packets']} packets, {st['analysed']} acquisitions "
                f"analysed, host wall {st['wall_s']:.3f} s (CPU run {cpu_stats[e]['wall_s']:.3f} "
                f"s), ingest {st['ingest_msamp_s']:.3f} Msamp/s, B1 launches "
                f"{st['b1_launches']}, [FDD] lines {st['fdd_lines']}, [SSI] lines "
                f"{st['ssi_lines']}")
        walls = [st["wall_s"] for st in stats]
        log(f"[22 times] gateway epoch host wall median {statistics.median(walls):.3f} s of "
            f"{[round(w, 3) for w in walls]} (card), CPU run median "
            f"{statistics.median(st['wall_s'] for st in cpu_stats):.3f} s; ingest median "
            f"{statistics.median(st['ingest_msamp_s'] for st in stats):.3f} Msamp/s; {card}")

        # One more epoch of the card run, under the profiler: device busy
        # time (kernels and copies) against that epoch's host wall.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        traffic, beat = epochs[GATEWAY_EPOCHS]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            card_side.feed(traffic)
            card_side.feed(beat)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        card_side.svc.stop()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        busy = sum(ev.device_time for ev in events) / 1e6
        kernels = sum(1 for ev in events if not ev.name.startswith(("Memcpy", "Memset")))
        top: dict[str, float] = {}
        for ev in events:
            top[ev.name[:60]] = top.get(ev.name[:60], 0.0) + ev.device_time / 1e3
        top5 = sorted(top.items(), key=lambda kv: -kv[1])[:5]
        log(f"[22 times] profiled gateway epoch: host wall {wall:.3f} s (under the profiler), "
            f"device busy {busy * 1e3:.3f} ms in {kernels} kernels + "
            f"{len(events) - kernels} copies/sets, idle share {1 - busy / wall:.4f}; top "
            f"device time (ms) {[(k, round(v, 3)) for k, v in top5]}; {card}")

    proc = subprocess.run(
        [sys.executable, "-m", "apda_fft_tpu_torch.gateway", "--simulate", "--sensors", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    peaks = [ln for ln in proc.stdout.splitlines() if "Peaks:" in ln]
    assert len(peaks) == 4, proc.stdout[-4000:]
    for i, line in enumerate(peaks):
        found = [float(f) for f in re.findall(r"f\d: ([0-9.]+)Hz", line)]
        for f in (8.0 + 3.1 * i, 40.0 + 2.7 * i):
            assert any(abs(g - f) < 0.2 for g in found), (i, f, line)
    log(f"[22 gateway] python -m apda_fft_tpu_torch.gateway --simulate --sensors 4 on the card: "
        f"exit 0, both modes of each sensor found")
    return launches, err


# ---------------------------------------------------------------- the mesh and the CLI


def _mesh_devices() -> tuple[list[str], str]:
    """Four shards: four distinct cards where the host has them, else four
    logical shards of ``cuda:0``."""
    cards = torch.cuda.device_count()
    if cards >= 4:
        return [f"cuda:{i}" for i in range(4)], "4 distinct cards"
    return ["cuda:0"] * 4, f"4 logical shards of cuda:0 ({cards} card(s) visible)"


def _assert_held(got, want, where: str) -> None:
    """``ROADMAP.md``'s "held against the reference" rule: decisions equal,
    4-/2-dp rounded fields within one rounding step, the rest within float32
    tolerance."""
    _assert_same(got, want, DECISIONS,
                 (("freq", 1.01e-4, 1e-6), ("mag", 1.01e-4, 1e-5), ("damping", 1.01e-2, 0),
                  ("q_factor", 1.01e-2, 0), ("prominence", 1e-4, 1e-5),
                  ("refined_freq", 1e-4, 1e-6)), where)


def phase_mesh(corpora: dict[str, np.ndarray], arrays: dict, signals,
               card: str) -> tuple[dict[str, int], dict[str, float]]:
    """The sharded paths on a 4-shard mesh of the card, each against the
    single-device run on the card: flexible epochs (refine) on the B=2048
    corpora, two each, the noisy one through the two-tier split; rigid and
    adaptive at B=256; one ``backend="pallas"`` epoch; the distributed FFT
    on a (2, 2) grid against float64 numpy.fft; ``correlation_blocks_sharded``
    and ``fdd(mesh=)`` on the ``[256, 16384]`` array; ``SpectralPipeline(mesh=)``
    on the gateway records; ``dryrun_multichip(4)``; times.  Every B1/B4 call
    is tapped and held against its plain twin.  Returns launches and errors."""
    from apda_fft_tpu_torch.ops.fft import center_and_pad
    from apda_fft_tpu_torch.parallel import distributed_fft, dryrun, mesh as pmesh

    t0 = time.perf_counter()
    devices, what = _mesh_devices()
    mesh = pmesh.make_mesh(4, devices=devices)
    log(f"[23 mesh] {mesh}: {what}")

    # Single-device references first, on their own budget tables.
    want, want_stats = {}, {}
    pipeline.reset_dynamic_state()
    for name, x in corpora.items():
        xs = torch.from_numpy(x).cuda()
        for epoch in range(2):
            want[name, epoch] = pipeline.analyze_epoch(xs, FS, n_fft=N_FFT, refine=True,
                                                       lowlat="never", batch_chunk=0)
            want_stats[name, epoch] = dict(pipeline.last_dynamic_stats())
    for mode, name in (("rigid", "clean"), ("adaptive", "noisy")):
        want[mode] = pipeline.analyze_epoch(corpora[name][:256], FS, n_fft=N_FFT, mode=mode,
                                            lowlat="never", batch_chunk=0)
    want["pallas"] = pipeline.analyze_epoch(corpora["clean"], FS, n_fft=N_FFT, refine=True,
                                            backend="pallas", lowlat="never", batch_chunk=0)

    pipeline.reset_dynamic_state()
    got, got_stats = {}, {}
    _zero_counts()
    with _Taps() as taps:
        for name, x in corpora.items():
            for epoch in range(2):
                got[name, epoch] = pmesh.analyze_epoch_sharded(x, FS, mesh=mesh, n_fft=N_FFT,
                                                               refine=True)
                got_stats[name, epoch] = dict(pipeline.last_dynamic_stats())
                log(f"[23 mesh] {name} epoch {epoch}: {got_stats[name, epoch]}")
        for mode, name in (("rigid", "clean"), ("adaptive", "noisy")):
            got[mode] = pmesh.analyze_epoch_sharded(corpora[name][:256], FS, mesh=mesh,
                                                    n_fft=N_FFT, mode=mode)
        got["pallas"] = pmesh.analyze_epoch_sharded(corpora["clean"], FS, mesh=mesh,
                                                    n_fft=N_FFT, refine=True, backend="pallas")
        torch.cuda.synchronize()
        epoch_launches = _counts()
        log(f"[23 mesh] kernel launches of the sharded epochs: {epoch_launches} "
            f"(B1 calls at {[tuple(c[0].shape) for c in taps.b1][:12]} ...)")
        assert epoch_launches["prominence_select_scan"] > 0, "no B1 launch on the mesh"
        assert epoch_launches["halfspec_fused"] > 0, "no B4 launch on the pallas mesh epoch"
        assert epoch_launches["lowlat_flexible"] == epoch_launches["lowlat_rigid"] == 0
        # B1 on every shard: each flat pass launches once a shard.
        assert sum(1 for c in taps.b1 if c[0].shape[0] == BATCH // 4) >= 4, "a shard without B1"
        err = taps.check("23 mesh epochs")
    assert got_stats["noisy", 1]["tier"] is not None, "the noisy mesh epoch did not run two-tier"
    for key, res in got.items():
        _assert_held(res, want[key], f"mesh epoch {key}")
        assert res.count.device == torch.device(devices[0]), res.count.device
    for key, st in got_stats.items():
        assert st == want_stats[key], (key, st, want_stats[key])
    log(f"[23 mesh] sharded epochs (2 x clean, 2 x noisy two-tier, rigid, adaptive, pallas) "
        f"held against the single-device run on the card; last_dynamic_stats() equal")

    # The sequence-parallel FFT on a (2, 2) grid.
    grid = pmesh.make_mesh(4, ("data", "seq"), shape=(2, 2), devices=devices)
    for n, b in ((N_FFT, BATCH), (65536, 16)):
        x = clean_batch(b, n)
        w = center_and_pad(torch.from_numpy(x).cuda(), n)
        mags = distributed_fft.distributed_halfspec_magnitudes(w, grid)
        ref = np.abs(np.fft.fft(w.cpu().numpy().astype(np.float64), axis=-1))[:, : n // 2]
        ref[:, 0] = 0.0
        e = float(np.linalg.norm(mags.cpu().numpy() - ref) / np.linalg.norm(ref))
        log(f"[23 mesh] distributed FFT (2, 2) at N={n}, B={b}: normwise error {e:.3e} "
            f"against float64 numpy.fft")
        assert e <= 1e-6, (n, e)

    # Modal arrays: time-sharded correlation blocks, bin-sharded FDD.
    x, _ = arrays[256]
    seq = pmesh.make_mesh(4, ("seq",), devices=devices)
    blocks = pmesh.correlation_blocks_sharded(x, 40, seq)
    ref = ssi.correlation_blocks(x, 40)
    assert np.allclose(blocks, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max()), \
        float(np.abs(blocks - ref).max())
    _zero_counts()
    with _Taps() as taps:
        f_mesh = modal.fdd(x, MODAL_FS, FDD_WINDOW, efdd=True, harmonics=True, mesh=mesh)
        fdd_launches = _counts()
        err = _max_err(err, taps.check("23 mesh fdd"))
    f_one = modal.fdd(x, MODAL_FS, FDD_WINDOW, efdd=True, harmonics=True)
    assert fdd_launches["prominence_select_scan"] == 1 == sum(fdd_launches.values())
    assert f_mesh.count == f_one.count == 3, (f_mesh.count, f_one.count)
    for f in ("idx", "freq"):
        np.testing.assert_array_equal(getattr(f_mesh, f), getattr(f_one, f), err_msg=f)
    np.testing.assert_allclose(f_mesh.sv1, f_one.sv1, rtol=1e-5, atol=1e-7 * f_one.sv1.max())
    log(f"[23 mesh] correlation_blocks_sharded [256, 16384] x 40 lags within rtol 2e-5 of the "
        f"single-device blocks; fdd(mesh=) count/idx/freq equal, B1 once")

    # Records: the gateway's epoch through SpectralPipeline(mesh=).
    recs = gateway_records(signals)
    _zero_counts()
    with _Taps() as taps:
        pipeline.reset_dynamic_state()
        on_mesh = batching.analyze_records(recs, analyze=pipeline.SpectralPipeline(
            pipeline.PipelineConfig(refine=True), mesh=mesh))
        rec_launches = _counts()
        err = _max_err(err, taps.check("23 mesh records"))
    pipeline.reset_dynamic_state()
    one = batching.analyze_records(recs, analyze=pipeline.SpectralPipeline(
        pipeline.PipelineConfig(refine=True)))
    _assert_records_equal(on_mesh, one, "mesh records vs one device")
    log(f"[23 mesh] SpectralPipeline(mesh=) on {len(recs)} gateway records equal to the "
        f"single-device records; launches {rec_launches}")

    line = dryrun.dryrun_multichip(4, devices=devices)
    log(f"[23 mesh] {line}")
    launches = {k: epoch_launches[k] + fdd_launches[k] + rec_launches[k] for k in epoch_launches}

    # Times: sharded vs single-device epochs on the noisy corpus at their
    # learned budgets (CUDA events, median of 20, interleaved).
    xs = torch.from_numpy(corpora["noisy"]).cuda()
    ms_one = event_ms(lambda: pipeline.analyze_epoch(xs, FS, n_fft=N_FFT, refine=True,
                                                     lowlat="never", batch_chunk=0))
    ms_mesh = event_ms(lambda: pmesh.analyze_epoch_sharded(xs, FS, mesh=mesh, n_fft=N_FFT,
                                                           refine=True))
    ms_one2 = event_ms(lambda: pipeline.analyze_epoch(xs, FS, n_fft=N_FFT, refine=True,
                                                      lowlat="never", batch_chunk=0))
    wall = _wall_ms(lambda: pmesh.analyze_epoch_sharded(xs, FS, mesh=mesh, n_fft=N_FFT,
                                                        refine=True), runs=20)
    log(f"[23 times] noisy B={BATCH} N={N_FFT} flexible refine epoch: single device "
        f"{BATCH / ms_one * 1e3:.0f} / {BATCH / ms_one2 * 1e3:.0f} windows/s "
        f"({ms_one:.3f} / {ms_one2:.3f} ms), mesh ({what}) {BATCH / ms_mesh * 1e3:.0f} "
        f"windows/s ({ms_mesh:.3f} ms; host wall {wall:.3f} ms); CUDA events, median of "
        f"{TIMING_RUNS}; {card}")
    pipeline.reset_dynamic_state()
    log(f"[23 elapsed] phase 23 in {time.perf_counter() - t0:.1f} s")
    return launches, err


#: ``python -m apda_fft_tpu_torch`` JSON keys whose floats the CLI or the
#: reference's detector rounds, with the step (``tests/test_torch_cli.py``).
CLI_ROUND_STEP = {"re": 1e-4, "im": 1e-4, "sv_ratio": 1e-4, "damping_efdd_pct": 1e-3,
                  "kurtosis": 1e-3, "freq_std": 1e-4, "damping_std_pct": 1e-3, "mpc": 1e-4,
                  "velocity_rms_mms": 1e-4, "freq": 1e-4, "mag": 1e-4, "damping": 1e-2,
                  "q_factor": 1e-2, "damping_pct": 1e-2}
_CLI_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _cli_close(a, b, key: str = "") -> bool:
    """Two CLI outputs, the card's and the CPU run's, equal up to float32:
    keys, strings and integers equal; floats within 1e-4 relative (phase
    19's card-vs-CPU bound for the field ops) plus 1e-5 and one rounding
    step where the CLI or the detector rounds; a text line's numbers within
    one step of their last printed digit plus 1e-4 relative."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_cli_close(a[k], b[k], k) for k in a))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _cli_close(x, y, key) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1.01 * CLI_ROUND_STEP.get(key, 0.0) + 1e-4 * abs(b) + 1e-5
    if isinstance(a, str) and isinstance(b, str) and not a.startswith("{"):
        na, nb = _CLI_NUM.findall(a), _CLI_NUM.findall(b)
        if _CLI_NUM.sub("#", a) != _CLI_NUM.sub("#", b) or len(na) != len(nb):
            return False
        for x, y in zip(na, nb):
            mant, _, exp = x.partition("e")
            if x != y and ("." not in mant or abs(float(x) - float(y)) > 1.01 * 10.0 ** (
                    int(exp or 0) - len(mant.split(".")[1])) + 1e-4 * abs(float(y))):
                return False
        return True
    return a == b


def _ssi_cli_close(a: dict, b: dict) -> bool:
    """Two ``ssi --json`` lines under ``tests/test_torch_ssi.py``'s rule (a
    pole at a tolerance's edge may join or leave a cluster and move its
    medians by the cluster's spread): the same modes, ``n_orders`` within
    1, frequencies within rtol 2e-5 and dampings within rtol 1e-2 plus the
    spread, shapes at MAC >= 0.9999, the harmonic flag equal."""
    if {k: v for k, v in a.items() if k != "modes"} != \
            {k: v for k, v in b.items() if k != "modes"} or len(a["modes"]) != len(b["modes"]):
        return False
    for x, y in zip(a["modes"], b["modes"]):
        sx = np.array([c["re"] + 1j * c["im"] for c in x["shape"]])
        sy = np.array([c["re"] + 1j * c["im"] for c in y["shape"]])
        if (x.keys() != y.keys() or abs(x["n_orders"] - y["n_orders"]) > 1
                or abs(x["freq"] - y["freq"]) > 2e-5 * y["freq"] + y["freq_std"] + 1.01e-4
                or abs(x["damping_pct"] - y["damping_pct"])
                > 1e-2 * y["damping_pct"] + y["damping_std_pct"] + 1.01e-3
                or modal.modal_assurance(sx, sy)[0, 0] < 0.9999
                or x.get("harmonic") != y.get("harmonic")):
            return False
    return True


def phase_cli(signals, card: str) -> None:
    """``python -m apda_fft_tpu_torch`` in subprocesses on generated log
    files: every analysing subcommand on the card (the default) and with
    ``--device cpu`` (one intra-op thread), outputs equal up to float32
    (:func:`_cli_close`; SSI under :func:`_ssi_cli_close`); ``doctor`` exits
    0 on the card, and
    ``oracle-check`` prints MATCH for every file and mode."""
    import tempfile

    from apda_fft_tpu_torch.io import logfile

    t0 = time.perf_counter()

    def write(path, x, fs=FS):
        logfile.write_acquisition_header(path, "10:20:30", "2g", f"{fs:g} Hz", "X axis",
                                         "Synced", means=["22.0", "0.01", "0.01", "0.98"],
                                         humidity=50.0, baselines=(0.0, 0.0, 0.0))
        logfile.append_samples(path, [f"{v:8.6f}" for v in x])
        return path

    with tempfile.TemporaryDirectory(prefix="apda_cli_") as d:
        x, _ = modal_array(4)
        sensors = [write(os.path.join(d, f"0013a20041e7f6b{s}_Xaxis_16_08_2026_10_20_3{s}.log"),
                         x[s], MODAL_FS) for s in range(4)]
        t = np.arange(2048) / FS
        shock = write(os.path.join(d, "0013a20041e7f6c0_Xaxis_16_08_2026_10_21_00.log"),
                      np.exp(-3.0 * t) * np.sin(2 * np.pi * 40.0 * t) * 5.0)
        t = np.arange(1024) / FS
        track = [write(os.path.join(d, f"0013a20041e7f6b7_Xaxis_1{e}_08_2026_10_20_30.log"),
                       np.sin(2 * np.pi * 25.0 * (1 - 0.01 * e) * t)  # 1 %/acquisition drift
                       + 0.6 * np.sin(2 * np.pi * 47.7 * t)) for e in range(6)]
        cases = {
            "analyze": ["analyze", *sensors, "--json", "--refine"],
            "analyze-adaptive-pallas": ["analyze", *sensors, shock, "--json", "--mode",
                                        "adaptive", "--backend", "pallas"],
            "welch": ["welch", *sensors, "--json", "--refine"],
            "spectrogram": ["spectrogram", sensors[0], "--json"],
            "psd": ["psd", *sensors[:2], "--json"],
            "coherence": ["coherence", sensors[0], sensors[1], "--json"],
            "fdd": ["fdd", *sensors, "--json", "--efdd", "--harmonics"],
            "ssi": ["ssi", *sensors, "--json", "--block-rows", "12"],
            "srs": ["srs", shock, "--json"],
            "severity": ["severity", *sensors, shock, "--json"],
            "integrate": ["integrate", sensors[0], "--json", "--mms"],
            "track": ["track", *track, "--rel-drift", "0.02"],
            "oracle-check": ["oracle-check", *sensors, shock, *track[:2]],
        }
        env = {**os.environ, "PYTHONPATH": ROOT}
        cpu_env = {**env, "OMP_NUM_THREADS": "1"}

        def run(argv, extra, environ):
            proc = subprocess.run([sys.executable, "-m", "apda_fft_tpu_torch", *argv, *extra],
                                  cwd=ROOT, capture_output=True, text=True, timeout=300,
                                  env=environ)
            return proc.returncode, proc.stdout.splitlines(), proc.stderr[-2000:]

        jobs = {(name, side): (argv, extra, environ)
                for name, argv in cases.items()
                for side, extra, environ in (("card", [], env), ("cpu", ["--device", "cpu"],
                                                                 cpu_env))}
        jobs["doctor", "card"] = (["doctor", "--json"], [], env)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futures = {key: pool.submit(run, *job) for key, job in jobs.items()}
            out = {key: fut.result() for key, fut in futures.items()}
    for name in cases:
        (rc_g, lines_g, err_g), (rc_c, lines_c, err_c) = out[name, "card"], out[name, "cpu"]
        assert rc_g == rc_c and rc_g in (0, 2), (name, rc_g, rc_c, err_g, err_c)
        assert len(lines_g) == len(lines_c) > 0, (name, lines_g[-3:], lines_c[-3:])
        for a, b in zip(lines_g, lines_c):
            if name == "ssi":
                assert _ssi_cli_close(json.loads(a), json.loads(b)), (name, a, b)
            else:
                pa, pb = (json.loads(a), json.loads(b)) if a.startswith("{") else (a, b)
                assert _cli_close(pa, pb), (name, a, b)
        log(f"[24 cli] python -m apda_fft_tpu_torch {name}: exit {rc_g}, {len(lines_g)} lines, "
            f"card equal to --device cpu")
    oracle_lines = out["oracle-check", "card"][1]
    assert len(oracle_lines) == 2 * 7 and all(ln.endswith("MATCH") and "MISMATCH" not in ln
                                              for ln in oracle_lines), oracle_lines
    assert "ALERT" in "\n".join(out["track", "card"][1]), out["track", "card"][1]
    rc, lines, err_text = out["doctor", "card"]
    rep = json.loads(lines[-1])
    assert rc == 0 and rep["ok"], (rc, rep, err_text)
    log(f"[24 cli] doctor on the card: exit 0, "
        f"{[(c['name'], c['detail'][:60]) for c in rep['checks']]}")
    log(f"[24 cli] oracle-check on the card: MATCH for all 7 files x 2 modes; "
        f"{len(jobs)} subprocesses, 8 at a time, in {time.perf_counter() - t0:.1f} s; {card}")


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    corpora_err = phase_kernel_vs_plain()
    phase_spectrum()
    corpora = {"clean": clean_batch(BATCH), "noisy": noisy_batch(BATCH)}
    launches, main_err = phase_main_path(corpora)
    k_ms, p_ms = phase_times(corpora, card)
    lowlat_err = phase_lowlat_vs_plain()
    lowlat_launches, route_err = phase_route(
        _load_oracle(), _load_module("apda_signals", "signals.py"))
    lowlat_times = phase_lowlat_times(card)
    halfspec_err = phase_halfspec_vs_plain()
    halfspec_launches, pallas_err = phase_pallas_path(corpora)
    scan_launches, scan_err = phase_scans_vs_plain(corpora)
    new_times = phase_new_times(corpora, card)
    oracle, signals = _load_oracle(), _load_module("apda_signals", "signals.py")
    paths = {"records": phase_records(oracle, signals, card),
             "welch": phase_welch(oracle, card),
             "streams": phase_streams(oracle, signals, card)}
    phase_cross_spectra(card)
    paths["pipelined"] = phase_pipelined(corpora, oracle, card)
    log(f"[18 elapsed] phases 1-18 in {time.perf_counter() - t0:.1f} s")
    phase_field_ops(card)
    arrays = {s: modal_array(s) for s in MODAL_SENSORS}
    paths["fdd"] = phase_fdd(arrays, card)
    phase_ssi(arrays, card)
    log(f"[21 elapsed] phases 1-21 in {time.perf_counter() - t0:.1f} s")
    paths["gateway"] = phase_gateway(card)
    log(f"[22 elapsed] phases 1-22 in {time.perf_counter() - t0:.1f} s")
    paths["mesh"] = phase_mesh(corpora, arrays, signals, card)
    phase_cli(signals, card)
    log(f"[24 launches] by path: { {name: launches for name, (launches, _) in paths.items()} }")
    path_launches = {key: sum(p[0][key] for p in paths.values()) for key in _counts()}
    path_err = _max_err(*(err for _, err in paths.values()))
    log(f"[24 elapsed] phases 1-24 in {time.perf_counter() - t0:.1f} s")

    h, m12 = N_FFT // 2, 12
    # Per kernel, at the shapes its time was taken at: (bytes of its inputs
    # and outputs, float32 operations of |rfft|).  The DFT tables are the
    # four-step's, not the function's, so they count in neither; B2/B3's
    # detector operations are left out, which keeps the bound a lower one.
    work = {
        "prominence_select_scan": (BATCH * h * 4 + BATCH * m12 * 17 + BATCH * 8, 0),
        "lowlat_flexible": (N_FFT * 4 + 4 + 4 * (4 + 3 + 6 * 4), rfft_mag_flops(N_FFT)),
        "lowlat_rigid": (1024 * 4 + 4 + 4 * (5 + 3 + 6 * 5), rfft_mag_flops(1024)),
        "halfspec_fused": (BATCH * N_FFT * 6, BATCH * rfft_mag_flops(N_FFT)),
        "prominence_scans": (BATCH * h * 4 + BATCH * 32 * 16 + BATCH * 4, 0),
    }
    rows = [{
        "name": "prominence_select_scan",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches + path_launches["prominence_select_scan"],
        "max_abs_err": max(corpora_err, main_err, path_err["prominence_select_scan"]),
        "ms": k_ms,
        "plain_ms": p_ms,
        "library_ms": None,
    }]
    for name in ("lowlat_flexible", "lowlat_rigid"):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": LOWLAT_SOURCE,
            "replaces": LOWLAT_REPLACES[name],
            "launches": lowlat_launches[name] + path_launches[name],
            "max_abs_err": max(lowlat_err[name], route_err, path_err[name]),
            "ms": lowlat_times[name][0],
            "plain_ms": lowlat_times[name][1],
            "library_ms": None,
        })
    rows.append({
        "name": "halfspec_fused",
        "route": "cuda",
        "source": HALFSPEC_SOURCE,
        "replaces": HALFSPEC_REPLACES,
        "launches": halfspec_launches + path_launches["halfspec_fused"],
        "max_abs_err": max(halfspec_err, pallas_err, path_err["halfspec_fused"]),
        **new_times["halfspec_fused"],
    })
    rows.append({
        "name": "prominence_scans",
        "route": "cuda",
        "source": SCANS_SOURCE,
        "replaces": SCANS_REPLACES,
        "launches": scan_launches + path_launches["prominence_scans"],
        "max_abs_err": scan_err,
        **new_times["prominence_scans"],
    })
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*work[row["name"]])
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
