"""One whole window in one launch: the single-window latency route.

Counterpart of ``apda_fft_tpu/ops/latency_pallas.py``.
:func:`analyze_window_lowlat` analyses ONE full window - mean-centring, the
half-spectrum magnitudes, the detector, the finalize and the optional
sub-bin refine - in a single launch of a hand-written CUDA kernel
(``csrc/lowlat_window.cu``), one per mode, both on an FFT front end and the
select+scan kernel's selection: flexible (all picks scanned by warps at
once, then the ordered finalize) and rigid (the destructive greedy on one
warp, over the raw-magnitude ranking and the chunk summaries).  At one
window the batched pipeline is a chain of many small launches; the kernel
is one.

Dispatch is by the window's device: a CPU tensor runs
:func:`_analyze_window_lowlat_plain`, the same pipeline in plain torch; a
CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches per kernel.  ``analyze_epoch``'s single-window route, which has
placed and checked the window and the rate already, calls
:func:`_route_pass` once a pass instead of the public wrapper;
``route_calls`` counts both.

Both kernels read only the FFT's twiddle table, built in float64 on the
host and cached per window length and device: ``ops.fft_cuda._twiddle_table``
(the batched front-end kernel's).  They take windows of 64 to
``LOWLAT_MAX_N`` samples.  From ``CLUSTER_MIN_N`` samples on, where the
FFT's exchange buffers outgrow one block's shared memory, a window runs on
a second kernel per mode: one thread-block cluster, the buffers spread over
its CTAs' shared memory, the magnitudes and the detector on its first CTA
(whose shared memory must hold them: hence ``LOWLAT_MAX_N``).  Those
launches count under their own names.  A cluster the card cannot place
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import default_k, refine_subbin
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops.detector_cuda import _NOT_PLACED, CLUSTER_SIZE
from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes, is_pow2, next_pow2
from apda_fft_tpu_torch.ops.fft_cuda import _twiddle_table, rfft_mag_flops
from apda_fft_tpu_torch.ops.peaks_prominence import (
    _prominence_and_width,
    prominence_finalize,
    prominence_select,
)
from apda_fft_tpu_torch.ops.peaks_resolution import resolution_peaks
from apda_fft_tpu_torch.ops.stats import div_exact
from apda_fft_tpu_torch.utils import kernels
from apda_fft_tpu_torch.utils.placement import placed

#: Kernel launches so far, per kernel (one per call on a CUDA tensor).
launches = {"lowlat_flexible": 0, "lowlat_rigid": 0, "lowlat_flexible_cluster": 0,
            "lowlat_rigid_cluster": 0}


@kernels.counts_launches
def _count(name: str) -> None:
    """Advance :data:`launches` for a launch noted as ``name``."""
    if name in launches:
        launches[name] += 1


#: Calls so far: ``internal`` counts the single-window route's passes
#: (:func:`_route_pass`), ``public`` the calls of :func:`analyze_window_lowlat`.
route_calls = {"internal": 0, "public": 0}

#: Longest window the kernels take: the window's N/2 magnitudes must fit in
#: the shared memory of one block, or of a cluster's first CTA (227 KB on
#: Hopper).
LOWLAT_MAX_N = 65536
#: Shortest window that runs on the cluster kernels (``csrc/lowlat_window.cu``
#: ``layout()``): from here the two FFT exchange buffers outgrow one block.
CLUSTER_MIN_N = 32768

#: Threads of a block per kernel, pinned (a multiple of 32, at most 1024), or
#: None for the count by window length of :func:`_block_threads`.
_THREADS: dict[str, int | None] = {"flexible": None, "rigid": None}


def kernel_name(mode: str, n: int) -> str:
    """The kernel an ``n``-sample window launches in ``mode``, as
    :data:`launches` counts it."""
    return f"lowlat_{mode}" + ("_cluster" if n >= CLUSTER_MIN_N else "")


def _block_threads(mode: str, n: int) -> int:
    """N/8 threads, at least 256 and at most 1024 (a block, or each CTA of
    a cluster): on an H100 the fastest of 256 / 512 / 1024 for both kernels
    at N = 1024, 4096, 16384, and 32768 and 65536 on the cluster kernels
    (``chip_profile.py --block-sizes``, PERF.md).  Longer windows have more
    FFT butterflies and bins a pass; shorter ones gain from the shorter
    block reductions and barriers of fewer warps."""
    return _THREADS[mode] or min(1024, max(256, n // 8))

_KERNEL = "lowlat_window"
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = kernels.load(_KERNEL)
        fn = lib.apda_lowlat_window
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        smem = lib.apda_lowlat_smem_bytes
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, smem, lib.apda_cuda_error_string)
    return _fn


def _analyze_window_lowlat_plain(
    x: torch.Tensor, fs: torch.Tensor, *, n_fft: int, mode: str, k: int, budget: int,
    refine: bool,
) -> EpochResult:
    """Plain torch version of the kernels: the batched pipeline's stages on
    the one window ``x [N]`` (``fs`` a 0-dim tensor on its device)."""
    w = x[None] - div_exact(x.sum(), float(n_fft))
    mags = halfspec_magnitudes(w, backend="matmul")
    fs_flat = fs.reshape(1)
    if mode == "flexible":
        cid, is_cand, cmag, _, std, n_cand = prominence_select(mags, budget)
        proms, bins = _prominence_and_width(mags, cid, cmag)
        det = prominence_finalize(cid, is_cand, cmag, proms, bins, fs_flat, n_fft, k, std,
                                  n_cand)
        prom, damp, qf, n_req = det.prominence, det.damping, det.q_factor, det.n_required
    else:
        det = resolution_peaks(mags, fs_flat, n_fft, k=k)
        prom = damp = qf = torch.zeros_like(det.freq)
        n_req = torch.zeros_like(det.n_candidates)  # rigid mode has no budget
    if refine:
        refined = refine_subbin(mags, det.idx, div_exact(fs_flat, float(n_fft)))
    else:
        refined = torch.zeros_like(det.freq)
    return EpochResult(
        count=det.count, idx=det.idx, freq=det.freq, mag=det.mag, prominence=prom,
        damping=damp, q_factor=qf, refined_freq=refined, n_candidates=det.n_candidates,
        n_required=n_req,
    )


def lowlat_work(n: int, k: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one launch on an ``n``-sample window
    with ``k`` slots: the window and the rate read once, ``k + 3`` int32 and
    ``6 * k`` float32 outputs written once, and |rfft|; the detector's
    operations are left out, which keeps a bound a lower one."""
    return n * 4 + 4 + 4 * (k + 3 + 6 * k), rfft_mag_flops(n)


def _result_views(out: torch.Tensor, lead: tuple, k: int
                  ) -> tuple[EpochResult, torch.Tensor]:
    """The fields of one window's result as views of ``out``, the kernels'
    int32 words ``[idx k | count | n_candidates | n_required]`` followed by
    the float32 words ``[freq | mag | prominence | damping | q_factor |
    refined_freq]``, k each, at batch shape ``lead`` (all ones); and the view
    ``[count, n_candidates, n_required]`` for one readback.  One
    ``as_strided`` a field: the fewest operations that give each its shape."""
    i, f = out.as_strided, out.view(torch.float32).as_strided
    row, row_st = (*lead, k), (k,) * len(lead) + (1,)
    one, one_st = tuple(lead), (1,) * len(lead)
    o = k + 3
    return EpochResult(
        count=i(one, one_st, k), idx=i(row, row_st, 0), freq=f(row, row_st, o),
        mag=f(row, row_st, o + k), prominence=f(row, row_st, o + 2 * k),
        damping=f(row, row_st, o + 3 * k), q_factor=f(row, row_st, o + 4 * k),
        refined_freq=f(row, row_st, o + 5 * k), n_candidates=i(one, one_st, k + 1),
        n_required=i(one, one_st, k + 2),
    ), i((3,), (1,), k)


def _launch(x: torch.Tensor, fs: torch.Tensor, *, lead: tuple, mode: str, k: int,
            budget: int, refine: bool) -> tuple[EpochResult, torch.Tensor]:
    """One launch on the contiguous window ``x [N]`` and the 0-dim rate
    ``fs`` on its card; the result as :func:`_result_views` gives it, in
    one fresh allocation."""
    n = x.shape[-1]
    if n > LOWLAT_MAX_N:
        raise ValueError(
            f"window length {n} exceeds the latency kernel's limit LOWLAT_MAX_N="
            f"{LOWLAT_MAX_N} (its magnitudes must fit in one block's shared memory)"
        )
    dev = x.device
    fn, smem_bytes, err_str = _kernel_fn()
    table = _twiddle_table(n, dev)
    if x.data_ptr() % 16:  # the kernels read the window as float4
        x = x.clone()
    out = torch.empty(7 * k + 3, dtype=torch.int32, device=dev)
    iout = out.data_ptr()
    rc = fn(
        int(mode == "rigid"), x.data_ptr(), n, table.data_ptr(), fs.data_ptr(),
        k, budget, int(refine), iout, iout + 4 * (k + 3), _block_threads(mode, n),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    name = kernel_name(mode, n)
    if rc == _NOT_PLACED:
        raise RuntimeError(
            f"{name} launch failed (N={n}, k={k}, budget={budget}): a cluster of "
            f"{CLUSTER_SIZE} CTAs with {smem_bytes(n)} bytes of shared memory each cannot be "
            f"placed on {torch.cuda.get_device_name(dev)} "
            f"(cudaOccupancyMaxActiveClusters = 0)"
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed (N={n}, k={k}, budget={budget}): "
            f"{err_str(rc).decode()} (cudaError {rc})"
        )
    kernels.note_launch(name, *lowlat_work(n, k))
    return _result_views(out, lead, k)


def _check_window(n: int, mode: str, k: int) -> None:
    """The kernels' limits on a full window of ``n`` samples."""
    if not is_pow2(n) or n < 64:
        raise ValueError(f"window length must be a power of two >= 64, got {n}")
    if mode not in ("flexible", "rigid"):
        raise ValueError(f"unknown mode {mode!r}; expected 'flexible' or 'rigid'")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _route_pass(x: torch.Tensor, fs: torch.Tensor, *, lead: tuple, mode: str, k: int,
                budget: int, refine: bool) -> tuple[EpochResult, torch.Tensor]:
    """One pass of ``analyze_epoch``'s single-window route.

    What :func:`analyze_window_lowlat` does, without its placing and checks:
    the route hands over the contiguous window ``x [N]`` and its 0-dim
    float32 rate ``fs`` on one device, both placed, and has checked the
    window by :func:`_check_window`.  Returns the result at batch shape
    ``lead`` and its ``[count, n_candidates, n_required]`` view
    (:func:`_result_views`).  A CPU window runs the plain version, laid out
    as the kernels lay out theirs.
    """
    route_calls["internal"] += 1
    n = x.shape[-1]
    budget = min(budget, n // 2)
    if x.device.type != "cpu":
        return _launch(x, fs, lead=lead, mode=mode, k=k, budget=budget, refine=refine)
    r = _analyze_window_lowlat_plain(x, fs, n_fft=n, mode=mode, k=k, budget=budget,
                                     refine=refine)
    floats = torch.cat([r.freq, r.mag, r.prominence, r.damping, r.q_factor, r.refined_freq])
    out = torch.cat([r.idx.reshape(-1), r.count, r.n_candidates, r.n_required,
                     floats.reshape(-1).view(torch.int32)])
    return _result_views(out, lead, k)


def analyze_window_lowlat(
    x,
    fs,
    *,
    n_fft: int | None = None,
    mode: str = "rigid",
    k: int | None = None,
    max_candidates: int = 8,
    refine: bool = False,
) -> EpochResult:
    """Analyze ONE full window in a single kernel launch.

    Latency counterpart of ``models.pipeline.analyze_epoch`` with the same
    decision semantics.  ``x`` is ``[N]`` or ``[1, N]`` with ``N == n_fft``
    (full windows only - ragged or padded windows take the batched path),
    a tensor or an array.  A tensor runs where it lies; an array runs on
    CUDA and raises ``RuntimeError`` without a CUDA device (pass a CPU
    tensor for the CPU).  Returns an :class:`EpochResult` with batch shape
    [1] on that device.

    ``max_candidates`` bounds the flexible detector like the batched path's
    static budget; decisions are exact iff ``result.n_required <=
    max_candidates`` (the caller re-runs larger otherwise).
    """
    route_calls["public"] += 1
    x = placed(x, None, torch.float32)
    if x.dim() == 2:
        if x.shape[0] != 1:
            raise ValueError(f"latency path takes exactly one window, got {tuple(x.shape)}")
        x = x[0]
    if x.dim() != 1:
        raise ValueError(f"expected [N] or [1, N] samples, got shape {tuple(x.shape)}")
    n = x.shape[-1]
    if n_fft is None:
        n_fft = next_pow2(n)
    if n != n_fft:
        raise ValueError(
            f"latency path requires a full window (N == n_fft), got {n} vs {n_fft}"
        )
    if k is None:
        k = default_k(mode)
    _check_window(n, mode, k)
    budget = min(max_candidates, n // 2)
    fs = torch.as_tensor(
        fs.detach() if isinstance(fs, torch.Tensor) else np.asarray(fs),
        dtype=torch.float32, device=x.device,
    ).reshape(())
    kw = dict(mode=mode, k=k, budget=budget, refine=refine)
    if x.device.type == "cpu":
        return _analyze_window_lowlat_plain(x, fs, n_fft=n_fft, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no latency kernel for device {x.device}")
    return _launch(x.contiguous(), fs.contiguous(), lead=(1,), **kw)[0]
