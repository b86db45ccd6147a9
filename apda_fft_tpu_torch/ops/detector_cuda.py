"""The prominence detector's CUDA kernels and their plain twins.

Counterpart of ``apda_fft_tpu/ops/detector_pallas.py``:

* :func:`prominence_select_scan` (``prominence_select_scan_pallas``) - the
  fused kernel ``csrc/prominence_select_scan.cu`` runs the threshold,
  candidate selection and prominence/width scans of every window in one
  launch, one thread block per window; :func:`prominence_peaks_fused` adds
  the torch finalize on the small ``[B, M]`` outputs.  Every flexible
  detect pass of the epoch pipeline runs it.
* :func:`prominence_scans` (``prominence_scans_pallas``) - the kernel
  ``csrc/prominence_scans.cu`` runs only the scans, for candidates already
  selected; :func:`prominence_peaks_batch` is the batch-level detector
  around it (selection, scans, finalize), the cross-check path.

Dispatch is by the tensor's device: a CPU tensor runs the plain twin
(:func:`_prominence_select_scan_plain`, :func:`_prominence_scans_plain`); a
CUDA tensor launches the kernel or raises.  ``launches`` and
``scan_launches`` count kernel launches.  Both kernels take rows of any
length: a row that does not fit in a block's shared memory stays in device
memory, and the wrapper allocates the global workspace the kernel asks for
its chunk summaries when they do not fit either.
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

#: Select+scan kernel launches so far (one per call on a CUDA tensor with rows).
launches = 0
#: Scans-only kernel launches so far (one per call on a CUDA tensor with slots).
scan_launches = 0

#: Threads of a scans-kernel block, 128 or 256 (both keep 2048 threads on
#: an SM): within 2 % of each other at M=32 on an H100
#: (``chip_profile.py --block-sizes``, PERF.md).
_SCANS_THREADS = 128

_KERNEL = "prominence_select_scan"
_SCANS_KERNEL = "prominence_scans"
_fn = None
_scans_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = kernels.load(_KERNEL)
        fn = lib.apda_prominence_select_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_void_p] * 8), ctypes.c_int, ctypes.c_void_p,
        ]
        ws = lib.apda_select_scan_workspace_floats
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, ws, lib.apda_cuda_error_string)
    return _fn


def _scans_kernel_fn():
    global _scans_fn
    if _scans_fn is None:
        lib = kernels.load(_SCANS_KERNEL)
        fn = lib.apda_prominence_scans
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_void_p] * 6), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        ws = lib.apda_scans_workspace_floats
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _scans_fn = (fn, ws, lib.apda_cuda_error_string)
    return _scans_fn


def _workspace(floats: int, device: torch.device) -> torch.Tensor | None:
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


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
    cid = mags.new_empty((b, m), dtype=torch.int32)
    is_cand = mags.new_empty((b, m), dtype=torch.bool)
    cmag = mags.new_empty((b, m))
    proms = mags.new_empty((b, m))
    bins = mags.new_empty((b, m), dtype=torch.int32)
    std = mags.new_empty((b,))
    n_cand = mags.new_empty((b,), dtype=torch.int32)
    if b == 0:
        return cid, is_cand, cmag, proms, bins, std, n_cand
    fn, ws_floats, err_str = _kernel_fn()
    ws = _workspace(ws_floats(b, h), mags.device)
    rc = fn(
        mags.data_ptr(), b, h, m,
        cid.data_ptr(), is_cand.data_ptr(), cmag.data_ptr(), proms.data_ptr(),
        bins.data_ptr(), std.data_ptr(), n_cand.data_ptr(),
        ws.data_ptr() if ws is not None else None,
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


def _prominence_scans_plain(mags: torch.Tensor, cid: torch.Tensor, cmag: torch.Tensor,
                            n_valid: torch.Tensor):
    """Plain torch version of the scans kernel: the masked-reduction scans
    over all M slots, then prominence 0 / width 1 past each row's
    ``n_valid``."""
    proms, bins = _prominence_and_width(mags, cid, cmag)
    valid = torch.arange(cid.shape[-1], device=cid.device) < n_valid[:, None]
    return torch.where(valid, proms, 0.0), torch.where(valid, bins, 1)


def prominence_scans(mags: torch.Tensor, cid: torch.Tensor, cmag: torch.Tensor,
                     n_valid: torch.Tensor):
    """(prominence, width_bins) for the first ``n_valid`` candidates per window.

    ``mags [B, H]``, ``cid``/``cmag [B, M]`` (bins and peak magnitudes of
    the pre-selected slots, valid ones first), ``n_valid [B]``; cast to
    float32 / int32 / float32 / int32 as the JAX kernel casts them.  Returns
    ``[B, M]`` float32 prominences and int32 widths; slots past
    ``n_valid`` hold 0 / 1.
    """
    global scan_launches
    for name, t in (("mags", mags), ("cid", cid), ("cmag", cmag), ("n_valid", n_valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != mags.device:
            raise ValueError(f"{name} is on {t.device}, mags on {mags.device}")
    if mags.dim() != 2:
        raise ValueError(f"mags must be [B, H], got shape {tuple(mags.shape)}")
    b, h = mags.shape
    if cid.dim() != 2 or cid.shape[0] != b or cmag.shape != cid.shape:
        raise ValueError(
            f"cid and cmag must be [B, M] with B={b}, got {tuple(cid.shape)} and "
            f"{tuple(cmag.shape)}"
        )
    if n_valid.shape != (b,):
        raise ValueError(f"n_valid must be [B] with B={b}, got {tuple(n_valid.shape)}")
    m = cid.shape[1]
    mags = mags.to(torch.float32).contiguous()
    cid = cid.to(torch.int32).contiguous()
    cmag = cmag.to(torch.float32).contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if mags.device.type == "cpu":
        return _prominence_scans_plain(mags, cid, cmag, n_valid)
    if mags.device.type != "cuda":
        raise ValueError(f"no detector for device {mags.device}")
    prom = torch.empty((b, m), dtype=torch.float32, device=mags.device)
    bins = torch.empty((b, m), dtype=torch.int32, device=mags.device)
    if b == 0 or m == 0:
        return prom, bins
    fn, ws_floats, err_str = _scans_kernel_fn()
    ws = _workspace(ws_floats(b, h), mags.device)
    rc = fn(
        mags.data_ptr(), b, h, m, cid.data_ptr(), cmag.data_ptr(), n_valid.data_ptr(),
        prom.data_ptr(), bins.data_ptr(), ws.data_ptr() if ws is not None else None,
        _SCANS_THREADS,
        mags.device.index, torch.cuda.current_stream(mags.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{_SCANS_KERNEL} launch failed (B={b}, H={h}, M={m}): "
            f"{err_str(rc).decode()} (cudaError {rc})"
        )
    scan_launches += 1
    return prom, bins


def prominence_peaks_batch(
    mags: torch.Tensor,
    fs,
    n_fft: int,
    k: int = 4,
    max_candidates: int = 32,
) -> ProminencePeaks:
    """Batch-level prominence detection with the scans kernel.

    Same contract as :func:`~apda_fft_tpu_torch.ops.peaks_prominence.prominence_peaks`
    over ``mags [B, H]``: the one order-exact selection, then
    :func:`prominence_scans` on the valid prefix of each row's slots, then the
    torch finalize.  ``fs`` is a scalar or ``[B]``.
    """
    cid, is_cand, cmag, _, std, n_cand = prominence_select(mags, max_candidates)
    # Slots are in walk order with the invalid ones last, so the valid ones
    # form a prefix and a count is the kernel's loop bound.
    n_valid = is_cand.sum(dim=-1).to(torch.int32)
    proms, bins = prominence_scans(mags, cid, cmag, n_valid)
    return prominence_finalize(cid, is_cand, cmag, proms.to(mags.dtype), bins, fs, n_fft, k,
                               std, n_cand)
