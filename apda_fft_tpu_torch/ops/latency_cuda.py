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
launches per kernel.

Both kernels read only the FFT's twiddle table, built in float64 on the
host and cached per window length and device: ``ops.fft_cuda._twiddle_table``
(the batched front-end kernel's).  They take windows of 64 to
``LOWLAT_MAX_N`` samples: the magnitudes must fit in one block's shared
memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import _placed, default_k, refine_subbin
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes, is_pow2, next_pow2
from apda_fft_tpu_torch.ops.fft_cuda import _twiddle_table
from apda_fft_tpu_torch.ops.peaks_prominence import (
    _prominence_and_width,
    prominence_finalize,
    prominence_select,
)
from apda_fft_tpu_torch.ops.peaks_resolution import resolution_peaks
from apda_fft_tpu_torch.ops.stats import div_exact
from apda_fft_tpu_torch.utils import kernels

#: Kernel launches so far, per kernel (one per call on a CUDA tensor).
launches = {"lowlat_flexible": 0, "lowlat_rigid": 0}

#: Longest window the kernel takes: its N/2 magnitudes live in one block's
#: shared memory (227 KB on Hopper), the rest spills to a global workspace.
LOWLAT_MAX_N = 65536

#: Threads of a block per kernel, pinned (a multiple of 32, at most 1024), or
#: None for the count by window length of :func:`_block_threads`.
_THREADS: dict[str, int | None] = {"flexible": None, "rigid": None}


def _block_threads(mode: str, n: int) -> int:
    """N/8 threads, at least 256 and at most 1024: on an H100 the fastest of
    256 / 512 / 1024 for both kernels at N = 1024, 4096, 16384 and 65536
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
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        ws = lib.apda_lowlat_workspace_floats
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, ws, lib.apda_cuda_error_string)
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


def _launch(x: torch.Tensor, fs: torch.Tensor, *, mode: str, k: int, budget: int,
            refine: bool) -> EpochResult:
    n = x.shape[-1]
    if n > LOWLAT_MAX_N:
        raise ValueError(
            f"window length {n} exceeds the latency kernel's limit LOWLAT_MAX_N="
            f"{LOWLAT_MAX_N} (its magnitudes must fit in one block's shared memory)"
        )
    rigid = mode == "rigid"
    fn, ws_floats, err_str = _kernel_fn()
    table = _twiddle_table(n, x.device)
    if x.data_ptr() % 16:  # the kernels read the window as float4
        x = x.clone()
    iout = torch.empty(k + 3, dtype=torch.int32, device=x.device)
    fout = torch.empty(6 * k, dtype=torch.float32, device=x.device)
    nws = ws_floats(n)
    ws = torch.empty(nws, dtype=torch.float32, device=x.device) if nws else None
    rc = fn(
        int(rigid), x.data_ptr(), n, table.data_ptr(), fs.data_ptr(),
        k, budget, int(refine), iout.data_ptr(), fout.data_ptr(),
        ws.data_ptr() if ws is not None else None, _block_threads(mode, n),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    name = "lowlat_rigid" if rigid else "lowlat_flexible"
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed (N={n}, k={k}, budget={budget}): "
            f"{err_str(rc).decode()} (cudaError {rc})"
        )
    launches[name] += 1
    f = fout.view(6, 1, k)
    return EpochResult(
        count=iout[k:k + 1], idx=iout[:k].view(1, k), freq=f[0], mag=f[1], prominence=f[2],
        damping=f[3], q_factor=f[4], refined_freq=f[5], n_candidates=iout[k + 1:k + 2],
        n_required=iout[k + 2:k + 3],
    )


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
    x = _placed(x, None, torch.float32)
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
    if not is_pow2(n) or n < 64:
        raise ValueError(f"window length must be a power of two >= 64, got {n}")
    if mode not in ("flexible", "rigid"):
        raise ValueError(f"unknown mode {mode!r}; expected 'flexible' or 'rigid'")
    if k is None:
        k = default_k(mode)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
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
    return _launch(x.contiguous(), fs.contiguous(), **kw)
