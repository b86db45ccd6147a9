"""Spectral front end: centering, padding, tapers and the magnitude spectrum.

Counterpart of ``apda_fft_tpu/ops/fft.py``.  Behavioural contract (reference
``metrics/fft_iterativa.py:74-88``): subtract the median, zero-pad to a power
of two, DFT, zero the DC bin.

``halfspec_magnitudes`` has three backends:

* ``"matmul"`` - the Bailey four-step of the JAX package's
  ``_fourstep_pretranspose`` as float32 ``torch.matmul`` calls against
  float64-built DFT and twiddle tables.  The products run in IEEE float32:
  TF32 would keep about three decimal digits and break the 1e-6 spectrum
  contract, so the global TF32 setting is overridden for the call.
* ``"xla"`` - ``torch.fft.rfft``.
* ``"pallas"`` - the fused front-end kernel (``ops/fft_cuda.py``, the
  counterpart of the JAX package's ``fft_pallas.py``): one hand-written
  CUDA launch of an FFT on a CUDA tensor, its plain torch twin (the
  four-step) on a CPU tensor.  ``[B, N]`` windows only.

The numpy table builders are re-stated here (the port never imports the JAX
package); a test holds them bit-equal to the JAX package's.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch

from apda_fft_tpu_torch.ops.stats import median_lastaxis

#: N at or below which a single DFT matrix product replaces the four-step.
_DIRECT_DFT_MAX = 512

TAPERS = ("none", "hann", "hamming", "blackman")
BACKENDS = ("xla", "matmul", "pallas")
PRECISIONS = ("highest", "fast")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference ``metrics/fft_iterativa.py:13-22``)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def split_pow2(n: int) -> tuple[int, int]:
    """Factor a power of two as N1*N2 with N1 >= N2, both powers of two."""
    log = n.bit_length() - 1
    l1 = (log + 1) // 2
    return 1 << l1, 1 << (log - l1)


def split_lanes(n: int) -> tuple[int, int]:
    """Factor ``n = n1*n2`` with the minor factor ``n1 >= 128``.

    The same factorization as the JAX package, so both packages run the same
    four-step (and the same table sizes) at every N.
    """
    log = n.bit_length() - 1
    l1 = max(7, (log + 1) // 2)
    return 1 << l1, n >> l1


def center_and_pad(
    samples: torch.Tensor,
    n_fft: int,
    length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Median-center each window and zero-pad/mask to ``n_fft``.

    ``samples`` is ``[..., L]`` with ``L <= n_fft``.  If ``length`` is given,
    only the first ``length`` entries of each row are real data: the median
    is taken over that prefix and everything past it is zero.
    """
    if not is_pow2(n_fft):
        raise ValueError(f"n_fft must be a power of two, got {n_fft}")
    L = samples.shape[-1]
    if L > n_fft:
        raise ValueError(f"window length {L} exceeds n_fft {n_fft}")
    centered = samples - median_lastaxis(samples, length)[..., None]
    if length is not None:
        length = torch.as_tensor(length, device=samples.device)
        mask = torch.arange(L, device=samples.device) < length[..., None]
        centered = torch.where(mask, centered, torch.zeros((), dtype=samples.dtype,
                                                           device=samples.device))
    if L < n_fft:
        centered = torch.nn.functional.pad(centered, (0, n_fft - L))
    return centered


def taper_window(
    name: str,
    n: int,
    dtype: torch.dtype = torch.float32,
    lengths: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Amplitude-normalized taper of length ``n`` (numpy's symmetric
    ``hanning``/``hamming``/``blackman`` divided by the coherent gain).

    ``lengths`` (optional, any leading batch shape) gives per-record valid
    prefixes: the taper spans the first ``length`` samples of each record
    and is zero beyond, returning shape ``[..., n]``.
    """
    if name not in TAPERS:
        raise ValueError(f"unknown taper {name!r}; expected one of {TAPERS}")
    if name == "none":
        raise ValueError("taper_window called with 'none'; skip tapering instead")
    if lengths is not None:
        device = torch.as_tensor(lengths).device if device is None else device
    i = torch.arange(n, dtype=dtype, device=device)
    if lengths is None:
        m = torch.full((), float(n), dtype=dtype, device=device)
    else:
        m = torch.as_tensor(lengths, device=device).to(dtype)[..., None]
    one = torch.ones((), dtype=dtype, device=device)
    x = (2.0 * math.pi) * i / torch.maximum(m - 1.0, one)
    if name == "hann":
        w = 0.5 - 0.5 * torch.cos(x)
    elif name == "hamming":
        w = 0.54 - 0.46 * torch.cos(x)
    else:  # blackman
        w = 0.42 - 0.5 * torch.cos(x) + 0.08 * torch.cos(2.0 * x)
    valid = i < m
    w = torch.where(valid, w, torch.zeros((), dtype=dtype, device=device))
    gain = w.sum(dim=-1, keepdim=True) / torch.maximum(
        valid.to(dtype).sum(dim=-1, keepdim=True), one
    )
    # Degenerate 1-sample records have an all-zero hann taper; leave them
    # unscaled rather than dividing by zero.
    return torch.where(gain > 0, w / torch.where(gain > 0, gain, one), w)


# ---------------------------------------------------------------------------
# DFT / twiddle tables (float64 on the host, stored in the compute dtype)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_tables(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of W_n^{jk} = exp(-2i*pi*jk/n) = cos + i*sin."""
    # Reduce jk mod n in exact integer arithmetic first for table accuracy.
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


@functools.lru_cache(maxsize=None)
def _twiddle_tables(n1: int, n2: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of W_N^{k1*m2}, shape [n1, n2], N = n1*n2."""
    n = n1 * n2
    jk = np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=64)
def _direct_tables(n: int, n_out: int, dtype: torch.dtype, device: torch.device):
    """``[n, n_out]`` cos and sin operands of the direct DFT, on ``device``."""
    c, s = _dft_tables(n, _dtype_name(dtype))
    return tuple(torch.tensor(t[:n_out].T, device=device) for t in (c, s))


@functools.lru_cache(maxsize=64)
def _fourstep_tables(n: int, n_out: int, dtype: torch.dtype, device: torch.device):
    """Operands of the four-step at ``n``: stacked step-1 ``[cos; sin]``
    ``[2*n2, n2]``, twiddle cos/sin ``[n2, n1]``, step-3 ``[cos | sin]``
    ``[n1, 2*k1_out]`` - all on ``device``, each a copy that owns its memory
    (the numpy tables are cached and shared)."""
    name = _dtype_name(dtype)
    n1, n2 = split_lanes(n)
    k1_out = n_out // n2
    c2, s2 = _dft_tables(n2, name)
    tc, ts = _twiddle_tables(n2, n1, name)
    c1, s1 = (t[:, :k1_out] for t in _dft_tables(n1, name))
    host = (np.concatenate([c2, s2], axis=0), tc, ts, np.concatenate([c1, s1], axis=1))
    return tuple(torch.tensor(t, device=device) for t in host)


_ieee_lock = threading.Lock()
_ieee_depth = 0
_ieee_saved: list[str] = []


@contextlib.contextmanager
def ieee_fp32_matmul():
    """Run float32 matrix products in full IEEE float32 (no TF32 on CUDA, no
    reduced-precision oneDNN math on the CPU), restoring the caller's
    settings afterwards.

    PyTorch keeps the setting process-wide.  Overlapping calls from several
    threads share one override: the first to enter saves the caller's
    settings and the last to leave restores them, so none can leak.  While
    any call is inside, float32 matmuls on every thread run in IEEE.
    """
    global _ieee_depth
    knobs = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    with _ieee_lock:
        if _ieee_depth == 0:
            _ieee_saved[:] = [k.fp32_precision for k in knobs]
            for k in knobs:
                k.fp32_precision = "ieee"
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                for k, v in zip(knobs, _ieee_saved):
                    k.fp32_precision = v


def _fourstep_magnitudes(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """|X[k]| for k < n_out by the four-step, in final bin order.

    With ``a = x.reshape(..., n2, n1)`` (a free view), ``n = m1 + n1*m2`` and
    ``k = k2 + n2*k1``::

        X[k2 + n2*k1] = sum_m1 W_n1^{m1*k1} [ W_N^{m1*k2} sum_m2 a[m2, m1] W_n2^{m2*k2} ]

    ``k < n_out`` iff ``k1 < n_out / n2``, so step 3 keeps only those columns.
    """
    n = x.shape[-1]
    lead = x.shape[:-1]
    n1, n2 = split_lanes(n)
    k1_out = n_out // n2
    cs2, tc, ts, c1s1 = _fourstep_tables(n, n_out, x.dtype, x.device)
    a = x.reshape(*lead, n2, n1)
    # Step 1: DFT over m2, cos and sin rows in one product.
    b = torch.matmul(cs2, a)
    br, bi = b[..., :n2, :], b[..., n2:, :]
    # Step 2: twiddle W_N^{k2*m1}.
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    # Step 3: DFT over m1 against the stacked [cos | sin] table.
    p = torch.matmul(cr, c1s1)
    q = torch.matmul(ci, c1s1)
    dr = p[..., :k1_out] - q[..., k1_out:]
    di = p[..., k1_out:] + q[..., :k1_out]
    # |.| before the step-4 transpose: one array through the layout pass.
    dm = torch.sqrt(dr**2 + di**2)
    return dm.transpose(-1, -2).reshape(*lead, n_out)


def halfspec_magnitudes(
    x: torch.Tensor, backend: str = "matmul", precision: str = "highest"
) -> torch.Tensor:
    """|FFT| over the first N/2 bins of real windows ``x`` [..., N], DC zeroed.

    This is what the peak detectors consume.  ``backend`` is ``"matmul"``
    (the four-step), ``"xla"`` (``torch.fft.rfft``) or ``"pallas"`` (the
    fused front-end kernel of ``ops.fft_cuda``, ``[B, N]`` windows with N a
    power of two >= 64).  ``precision="fast"`` (a reduced-precision matmul
    mode) is not available until its error is measured on the card.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if precision == "fast":
        raise NotImplementedError(
            'precision="fast" is not ported yet: a TF32 mode needs its own '
            "measured error bound on the card"
        )
    n = x.shape[-1]
    if backend == "xla":
        mags = torch.fft.rfft(x)[..., : n // 2].abs().to(x.dtype)
    elif backend == "matmul":
        with ieee_fp32_matmul():
            if n <= _DIRECT_DFT_MAX:
                c, s = _direct_tables(n, n // 2, x.dtype, x.device)
                mags = torch.sqrt(torch.matmul(x, c) ** 2 + torch.matmul(x, s) ** 2)
            else:
                mags = _fourstep_magnitudes(x, n // 2)
    elif backend == "pallas":
        from apda_fft_tpu_torch.ops.fft_cuda import halfspec_magnitudes_fused

        return halfspec_magnitudes_fused(x)
    else:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {BACKENDS}")
    mags[..., 0] = 0
    return mags
