"""Fused front end: the hand-written CUDA kernel and its plain twin.

Counterpart of ``apda_fft_tpu/ops/fft_pallas.py``.
:func:`halfspec_magnitudes_fused` computes ``|FFT|`` of the first N/2 bins
of a ``[B, N]`` batch of real windows, DC zeroed, in one launch of a
hand-written CUDA kernel (``csrc/halfspec_fused.cu``): each row packed into
N/2 complex points, their FFT in radix-8 Stockham passes against one
float64-built twiddle table (:func:`_twiddle_table`), then the split into
the real transform's magnitudes.  It is what
``halfspec_magnitudes(x, backend="pallas")`` runs.

Dispatch is by the tensor's device: a CPU tensor runs
:func:`_halfspec_magnitudes_fused_plain`, the same four-step as IEEE float32
``torch.matmul`` calls; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, from the launches noted
(``utils.kernels.counts_launches``; a CUDA graph's replay notes its own).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from apda_fft_tpu_torch.ops.fft import (
    _dft_tables,
    _twiddle_tables,
    ieee_fp32_matmul,
    is_pow2,
    split_pow2,
)
from apda_fft_tpu_torch.utils import kernels

#: Kernel launches so far (one per call on a CUDA tensor with rows).
launches = 0

_KERNEL = "halfspec_fused"
_fn = None


@kernels.counts_launches
def _count(name: str) -> None:
    """Advance :data:`launches` for a launch noted as ``name``."""
    global launches
    launches += name == _KERNEL


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = kernels.load(_KERNEL)
        fn = lib.apda_halfspec_fused
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_void_p] * 3), ctypes.c_int, ctypes.c_void_p,
        ]
        ws = lib.apda_halfspec_workspace_floats
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int]
        lib.apda_cuda_error_string.restype = ctypes.c_char_p
        lib.apda_cuda_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, ws, lib.apda_cuda_error_string)
    return _fn


@functools.lru_cache(maxsize=32)
def _tables(n1: int, n2: int, device: torch.device = torch.device("cpu")):
    """The four-step's parameters (the plain twin's and the single-window
    kernels'), in the JAX package's layout:
    ``cs1`` ``[2*n1, n1]`` (cos rows, then sin rows), twiddles
    ``twc``/``tws`` ``[n1, n2]`` and the step-3 half tables ``c2h``/``s2h``
    ``[n2, n2/2]``, float32 from float64 builders, on ``device``."""
    c1, s1 = _dft_tables(n1, "float32")
    twc, tws = _twiddle_tables(n1, n2, "float32")
    c2f, s2f = _dft_tables(n2, "float32")
    n2h = n2 // 2
    host = (np.concatenate([c1, s1], axis=0), twc, tws, c2f[:, :n2h], s2f[:, :n2h])
    return tuple(torch.tensor(np.ascontiguousarray(t), device=device) for t in host)


# Unbounded: a pass replayed from a CUDA graph (``models/graphs.py``) reads
# the table where it was captured, so no entry may be freed.
@functools.lru_cache(maxsize=None)
def _twiddle_table(n: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The kernel's only parameters: ``W_n^k = exp(-2*pi*i*k/n)`` for
    ``k < n/2``, built in float64 and cast once to float32, as ``[n/2, 2]``
    (real, imaginary) pairs on ``device``."""
    w = np.exp(-2j * np.pi * np.arange(n // 2, dtype=np.float64) / n)
    host = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.tensor(host, device=device)


def _halfspec_magnitudes_fused_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel's function: the four-step DFT on
    ``x [B, N]`` float32 as IEEE float32 matmuls against float64-built
    tables (the JAX kernel's algorithm, not the CUDA kernel's).

    With ``a[m1, m2] = x[m2 + n2*m1]`` and ``k = k1 + n1*k2``::

        X[k] = sum_m2 W_n2^{m2*k2} [ W_N^{k1*m2} sum_m1 a[m1, m2] W_n1^{m1*k1} ]
    """
    b, n = x.shape
    n1, n2 = split_pow2(n)
    cs1, twc, tws, c2h, s2h = _tables(n1, n2, x.device)
    with ieee_fp32_matmul():
        # Step 1: DFT over m1, cos and sin rows in one product.
        bb = torch.matmul(cs1, x.reshape(b, n1, n2))
        br, bi = bb[:, :n1], bb[:, n1:]
        # Step 2: twiddle W_N^{k1*m2}.
        cr = br * twc - bi * tws
        ci = br * tws + bi * twc
        # Step 3: DFT over m2, the first n2/2 columns only (k < N/2).
        dr = torch.matmul(cr, c2h) - torch.matmul(ci, s2h)
        di = torch.matmul(cr, s2h) + torch.matmul(ci, c2h)
    mags = torch.sqrt(dr * dr + di * di)  # [b, k1, k2]
    out = mags.transpose(1, 2).reshape(b, n // 2)
    out[:, 0] = 0
    return out


def rfft_mag_flops(n: int) -> int:
    """Float32 operations that |rfft| of one real ``n``-point window needs,
    whatever the algorithm: 2.5*n*log2(n) for the real FFT (half of a
    complex radix-2 FFT's 5*n*log2(n)), then two multiplies, an add and a
    square root for each of the n/2 magnitudes.  The four-step does more
    (2*n*n1 + 4*(n/2)*n2 FMAs); a bound counts only what the function
    needs."""
    return int(2.5 * n * (n.bit_length() - 1)) + 4 * (n // 2)


def halfspec_work(b: int, n: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one kernel launch on ``[b, n]``
    windows: each window read once, its n/2 magnitudes written once (the
    twiddle table is the algorithm's, not the function's), and |rfft|."""
    return b * n * 6, b * rfft_mag_flops(n)


def _launch(x: torch.Tensor) -> torch.Tensor:
    b, n = x.shape
    fn, ws_floats, err_str = _kernel_fn()
    table = _twiddle_table(n, x.device)
    if x.data_ptr() % 16:  # the kernel reads rows as float4
        x = x.clone()
    out = x.new_empty((b, n // 2))
    nws = ws_floats(n)
    ws = torch.empty(b * nws, dtype=torch.float32, device=x.device) if nws else None
    rc = fn(
        x.data_ptr(), b, n, table.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{_KERNEL} launch failed (B={b}, N={n}): {err_str(rc).decode()} (cudaError {rc})"
        )
    kernels.note_launch(_KERNEL, *halfspec_work(b, n))
    return out


def halfspec_magnitudes_fused(x: torch.Tensor) -> torch.Tensor:
    """|FFT| of the first N/2 bins for real windows ``x`` [B, N], DC zeroed.

    Drop-in equivalent of ``halfspec_magnitudes(..., backend="xla")`` for
    float32 inputs: ``x`` is cast to float32, N must be a power of two >= 64,
    and the result is ``[B, N/2]`` float32 on ``x``'s device.
    """
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.dim() != 2:
        raise ValueError(f"expected [B, N] windows, got shape {tuple(x.shape)}")
    b, n = x.shape
    if not is_pow2(n) or n < 64:
        raise ValueError(f"window length must be a power of two >= 64, got {n}")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _halfspec_magnitudes_fused_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no front-end kernel for device {x.device}")
    if b == 0:
        return torch.empty((0, n // 2), dtype=torch.float32, device=x.device)
    return _launch(x.contiguous())
