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
``scan_launches`` count kernel launches, from the launches noted
(``utils.kernels.counts_launches``; a CUDA graph's replay notes its own).
Both kernels take rows past a block's shared memory (B1 from H = 57857, B5
from 58113, up to a few million bins) on one thread-block cluster of
``CLUSTER_SIZE`` CTAs a row; such a launch that the card refuses, or cannot
place, raises.
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
from apda_fft_tpu_torch.ops.stats import THRESHOLD_CLUSTER, THRESHOLD_SHARED_MAX_H
from apda_fft_tpu_torch.utils import kernels

#: Select+scan kernel launches so far (one per call on a CUDA tensor with rows).
launches = 0
#: Scans-only kernel launches so far (one per call on a CUDA tensor with slots).
scan_launches = 0
#: Of those, launches of each wrapper's cluster kernel (rows past
#: ``SELECT_SCAN_SHARED_MAX_H`` / ``SCANS_SHARED_MAX_H``).
cluster_launches = 0
cluster_scan_launches = 0

#: Threads of a scans-kernel block, 128 or 256 (both keep 2048 threads on
#: an SM): within 2 % of each other at M=32 on an H100
#: (``chip_profile.py --block-sizes``, PERF.md).
_SCANS_THREADS = 128

#: CTAs of the cluster that takes one row past a block's shared memory
#: (``csrc/cluster_common.cuh`` ``kClusterSize``).
CLUSTER_SIZE = THRESHOLD_CLUSTER
#: What a launch returns when not one cluster fits on the card.
_NOT_PLACED = -2
#: Longest rows each kernel keeps in one block's shared memory (its
#: ``kSharedMaxH``: 227 KB, less B1's 1 KB of static scratch, in floats);
#: longer rows launch its cluster kernel.
SELECT_SCAN_SHARED_MAX_H = THRESHOLD_SHARED_MAX_H
SCANS_SHARED_MAX_H = 227 * 1024 // 4

_KERNEL = "prominence_select_scan"
_SCANS_KERNEL = "prominence_scans"
#: Each wrapper notes a launch of its cluster kernel under this name.
_CLUSTER_KERNEL = _KERNEL + "_cluster"
_CLUSTER_SCANS_KERNEL = _SCANS_KERNEL + "_cluster"
_fn = None
_scans_fn = None


@kernels.counts_launches
def _count(name: str) -> None:
    """Advance the launch counters above for a launch noted as ``name``."""
    global launches, cluster_launches, scan_launches, cluster_scan_launches
    if name in (_KERNEL, _CLUSTER_KERNEL):
        launches += 1
        cluster_launches += name == _CLUSTER_KERNEL
    elif name in (_SCANS_KERNEL, _CLUSTER_SCANS_KERNEL):
        scan_launches += 1
        cluster_scan_launches += name == _CLUSTER_SCANS_KERNEL


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
        smem = lib.apda_select_scan_cluster_smem
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, smem, lib.apda_cuda_error_string)
    return _fn


def _scans_kernel_fn():
    global _scans_fn
    if _scans_fn is None:
        lib = kernels.load(_SCANS_KERNEL)
        fn = lib.apda_prominence_scans
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_void_p] * 5), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        smem = lib.apda_scans_cluster_smem
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _scans_fn = (fn, smem, lib.apda_cuda_error_string)
    return _scans_fn


def _launch_error(kernel: str, rc: int, err_str, smem_bytes, device, b: int, h: int,
                  m: int) -> RuntimeError:
    """The error of a launch that returned ``rc``: the ``cudaError`` text, or
    for a cluster that cannot be placed, the cluster and its shared memory."""
    shape = f"B={b}, H={h}, M={m}"
    if rc == _NOT_PLACED:
        return RuntimeError(
            f"{kernel} launch failed ({shape}): a cluster of {CLUSTER_SIZE} CTAs with "
            f"{smem_bytes()} bytes of shared memory each cannot be placed on "
            f"{torch.cuda.get_device_name(device)} (cudaOccupancyMaxActiveClusters = 0)"
        )
    return RuntimeError(
        f"{kernel} launch failed ({shape}): {err_str(rc).decode()} (cudaError {rc})"
    )


def select_scan_work(b: int, h: int, m: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one select+scan launch on ``[b, h]``
    magnitudes at ``m`` slots: the magnitudes read once, then the seven
    outputs written once (``[b, m]`` int32 / bool / float32 / float32 /
    int32 slots, 17 bytes a slot, and ``[b]`` std and count); its
    comparisons are not float32 arithmetic, so it counts none."""
    return b * h * 4 + b * m * 17 + b * 8, 0


def scans_work(b: int, h: int, m: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one scans launch on ``[b, h]``
    magnitudes at ``m`` slots: the magnitudes, the slots' bins and peaks and
    the ``[b]`` valid counts read once, prominences and widths written once."""
    return b * h * 4 + b * m * 16 + b * 4, 0


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
    fn, smem, err_str = _kernel_fn()
    rc = fn(
        mags.data_ptr(), b, h, m,
        cid.data_ptr(), is_cand.data_ptr(), cmag.data_ptr(), proms.data_ptr(),
        bins.data_ptr(), std.data_ptr(), n_cand.data_ptr(),
        mags.device.index, torch.cuda.current_stream(mags.device).cuda_stream,
    )
    if rc != 0:
        raise _launch_error(_KERNEL, rc, err_str, lambda: smem(h, m), mags.device, b, h, m)
    kernels.note_launch(_CLUSTER_KERNEL if h > SELECT_SCAN_SHARED_MAX_H else _KERNEL,
                        *select_scan_work(b, h, m))
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
    fn, smem, err_str = _scans_kernel_fn()
    rc = fn(
        mags.data_ptr(), b, h, m, cid.data_ptr(), cmag.data_ptr(), n_valid.data_ptr(),
        prom.data_ptr(), bins.data_ptr(), _SCANS_THREADS,
        mags.device.index, torch.cuda.current_stream(mags.device).cuda_stream,
    )
    if rc != 0:
        raise _launch_error(_SCANS_KERNEL, rc, err_str, lambda: smem(h), mags.device, b, h, m)
    kernels.note_launch(_CLUSTER_SCANS_KERNEL if h > SCANS_SHARED_MAX_H else _SCANS_KERNEL,
                        *scans_work(b, h, m))
    return prom, bins


def prominence_peaks_batch(
    mags: torch.Tensor,
    fs,
    n_fft: int,
    k: int = 4,
    max_candidates: int = 32,
    selection: str = "topk",
) -> ProminencePeaks:
    """Batch-level prominence detection with the scans kernel.

    Same contract as :func:`~apda_fft_tpu_torch.ops.peaks_prominence.prominence_peaks`
    over ``mags [B, H]``: the one order-exact selection (every name of
    ``peaks_prominence.SELECTIONS``), then :func:`prominence_scans` on the
    valid prefix of each row's slots, then the torch finalize.  ``fs`` is a
    scalar or ``[B]``.
    """
    cid, is_cand, cmag, _, std, n_cand = prominence_select(mags, max_candidates, selection)
    # Slots are in walk order with the invalid ones last, so the valid ones
    # form a prefix and a count is the kernel's loop bound.
    n_valid = is_cand.sum(dim=-1).to(torch.int32)
    proms, bins = prominence_scans(mags, cid, cmag, n_valid)
    return prominence_finalize(cid, is_cand, cmag, proms.to(mags.dtype), bins, fs, n_fft, k,
                               std, n_cand)
