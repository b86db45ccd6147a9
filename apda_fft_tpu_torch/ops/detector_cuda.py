"""Fused select+scan detector: the hand-written CUDA kernel and its plain twin.

Counterpart of ``apda_fft_tpu/ops/detector_pallas.py``'s
``prominence_select_scan_pallas`` and ``prominence_peaks_fused_pallas``.
The kernel (``csrc/prominence_select_scan.cu``) runs the threshold,
candidate selection and prominence/width scans of every window in one
launch, one thread block per window; the finalize stage stays in torch on
the small ``[B, M]`` outputs.

Dispatch is by the tensor's device: a CPU tensor runs
:func:`_prominence_select_scan_plain`; a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from apda_fft_tpu_torch.ops.peaks_prominence import (
    ProminencePeaks,
    _prominence_and_width,
    prominence_finalize,
    prominence_select,
)
from apda_fft_tpu_torch.utils import kernels

#: Kernel launches so far (one per call on a CUDA tensor with rows).
launches = 0

#: Largest spectrum the kernel takes: the row lives in shared memory, and a
#: block may use 227 KB of it on Hopper (1 KB kept for the reduction scratch).
MAX_H = (227 * 1024 - 1024) // 4

_KERNEL = "prominence_select_scan"
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = kernels.load(_KERNEL)
        fn = lib.apda_prominence_select_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_void_p] * 7), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, lib.apda_cuda_error_string)
    return _fn


def _prominence_select_scan_plain(mags: torch.Tensor, max_candidates: int):
    """Plain torch version of the kernel: ``prominence_select`` followed by
    the masked-reduction scans, same seven outputs."""
    cid, is_cand, cmag, _, std, n_cand = prominence_select(mags, max_candidates)
    proms, bins = _prominence_and_width(mags, cid, cmag)
    return cid, is_cand, cmag, proms, bins, std, n_cand


def prominence_select_scan(mags: torch.Tensor, max_candidates: int):
    """Fused candidate selection + prominence/width scans.

    ``mags [B, H]`` float32, contiguous -> ``(cid, is_cand, cmag, proms,
    bins, std, n_cand)``: ``[B, M]`` int32 / bool / float32 / float32 /
    int32 slots with ``M = min(max_candidates, H)``, then ``[B]`` float32
    std and int32 pre-budget candidate counts.  Slots are in the
    reference's walk order (4-dp-rounded magnitude descending, ties by
    ascending bin); slots past a row's candidates hold bin 0.
    """
    global launches
    if not isinstance(mags, torch.Tensor):
        raise TypeError(f"mags must be a torch.Tensor, got {type(mags).__name__}")
    if mags.dtype != torch.float32:
        raise TypeError(f"mags must be float32, got {mags.dtype}")
    if mags.dim() != 2:
        raise ValueError(f"mags must be [B, H], got shape {tuple(mags.shape)}")
    if not mags.is_contiguous():
        raise ValueError("mags must be contiguous")
    if max_candidates < 1:
        raise ValueError(f"max_candidates must be >= 1, got {max_candidates}")
    b, h = mags.shape
    m = min(int(max_candidates), h)
    if mags.device.type == "cpu":
        return _prominence_select_scan_plain(mags, m)
    if mags.device.type != "cuda":
        raise ValueError(f"no detector for device {mags.device}")
    if h > MAX_H:
        raise ValueError(
            f"H={h} does not fit the detector kernel's shared memory "
            f"(H*4 bytes must be <= {MAX_H * 4}); N >= 131072 is not supported on CUDA yet"
        )
    kw = dict(device=mags.device)
    cid = torch.empty((b, m), dtype=torch.int32, **kw)
    is_cand = torch.empty((b, m), dtype=torch.bool, **kw)
    cmag = torch.empty((b, m), dtype=torch.float32, **kw)
    proms = torch.empty((b, m), dtype=torch.float32, **kw)
    bins = torch.empty((b, m), dtype=torch.int32, **kw)
    std = torch.empty((b,), dtype=torch.float32, **kw)
    n_cand = torch.empty((b,), dtype=torch.int32, **kw)
    if b == 0:
        return cid, is_cand, cmag, proms, bins, std, n_cand
    fn, err_str = _kernel_fn()
    rc = fn(
        mags.data_ptr(), b, h, m,
        cid.data_ptr(), is_cand.data_ptr(), cmag.data_ptr(), proms.data_ptr(),
        bins.data_ptr(), std.data_ptr(), n_cand.data_ptr(),
        mags.device.index, torch.cuda.current_stream(mags.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{_KERNEL} launch failed (B={b}, H={h}, M={m}): "
            f"{err_str(rc).decode()} (cudaError {rc})"
        )
    launches += 1
    return cid, is_cand, cmag, proms, bins, std, n_cand


def prominence_peaks_fused(
    mags: torch.Tensor,
    fs,
    n_fft: int,
    k: int = 4,
    max_candidates: int = 32,
) -> ProminencePeaks:
    """Batched prominence detection: the fused select+scan, then the torch
    finalize on ``[B, M]``.  ``fs`` is a scalar or ``[B]``."""
    cid, is_cand, cmag, proms, bins, std, n_cand = prominence_select_scan(
        mags, max_candidates
    )
    return prominence_finalize(cid, is_cand, cmag, proms, bins, fs, n_fft, k, std, n_cand)
