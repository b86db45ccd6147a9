"""Spectral front end: centering, padding, tapers and the magnitude spectrum.

Counterpart of ``apda_fft_tpu/ops/fft.py``.  Behavioural contract (reference
``metrics/fft_iterativa.py:74-88``): subtract the median, zero-pad to a power
of two, DFT, zero the DC bin.

``halfspec_magnitudes`` has three backends:

* ``"matmul"`` - the Bailey four-step of the JAX package's
  ``_fourstep_pretranspose`` as float32 ``torch.matmul`` calls against
  float64-built DFT and twiddle tables.  The products run in IEEE float32:
  TF32 would keep about three decimal digits and break the 1e-6 spectrum
  contract, so the global TF32 setting is overridden for the call.  On the
  CPU they run on one intra-op thread (:func:`_one_cpu_thread`).
* ``"xla"`` - ``torch.fft.rfft``.
* ``"pallas"`` - the fused front-end kernel (``ops/fft_cuda.py``, the
  counterpart of the JAX package's ``fft_pallas.py``): one hand-written
  CUDA launch of an FFT on a CUDA tensor, its plain torch twin (the
  four-step) on a CPU tensor.  ``[B, N]`` windows only.

Complex spectra (the cross spectra's front end) come from the same
four-step: :func:`fft_matmul_real` returns ``(re, im)`` of all N bins or the
first N/2, :func:`rfft_packed_matmul` the first N/2 by the packed real-input
transform, :func:`full_spectrum` the complex spectrum with DC zeroed.

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


@functools.lru_cache(maxsize=None)
def _untwist_tables(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of W_N^k = exp(-2i*pi*k/N) for k = 0..N/2-1 (rfft untwist)."""
    k = np.arange(n // 2, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k.astype(np.float64)
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
    """Run float32 matrix products and convolutions in full IEEE float32 (no
    TF32 in cuBLAS or cuDNN on CUDA, no reduced-precision oneDNN math on the
    CPU), restoring the caller's settings afterwards.

    cuDNN convolutions allow TF32 by default, unlike cuBLAS matmuls; the
    anti-aliasing filters of ``ops/resample.py`` need IEEE float32 for their
    alias floor, as the JAX package asks with ``Precision.HIGHEST``.

    PyTorch keeps the setting process-wide.  Overlapping calls from several
    threads share one override: the first to enter saves the caller's
    settings and the last to leave restores them, so none can leak.  While
    any call is inside, float32 matmuls and convolutions on every thread run
    in IEEE.
    """
    global _ieee_depth
    knobs = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul,
             torch.backends.cudnn.conv, torch.backends.mkldnn.conv)
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


_cpu_thread_lock = threading.RLock()


@contextlib.contextmanager
def _one_cpu_thread(x: torch.Tensor):
    """Run a transform of ``x`` on the CPU on the calling thread alone
    (``torch.set_num_threads(1)`` for the call, then the caller's count);
    a CUDA tensor's transform is left as it is.

    On the host CPU of an NVIDIA H100 machine, the front end at 8 intra-op
    threads returned 4 of 260 epochs of 256 windows with one thread's block
    of 32 windows off by about 2.2e-4 relative (oneMKL 2024.0
    ``SGEMM_BATCH``), where one thread never did (``chip_profile.py
    --cpu-probe``).  The guard gives up the CPU transform's other threads
    for that.  ``torch.set_num_threads`` also sets the count that threads
    starting parallel work take up, so concurrent guards take turns.
    """
    if x.device.type != "cpu":
        yield
        return
    with _cpu_thread_lock:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _fourstep_pretranspose(x: torch.Tensor, n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 of the four-step: ``(dr, di)`` in ``[..., n2 (k2), k1_out]``.

    With ``a = x.reshape(..., n2, n1)`` (a free view), ``n = m1 + n1*m2`` and
    ``k = k2 + n2*k1``::

        X[k2 + n2*k1] = sum_m1 W_n1^{m1*k1} [ W_N^{m1*k2} sum_m2 a[m2, m1] W_n2^{m2*k2} ]

    ``k < n_out`` iff ``k1 < n_out / n2``, so step 3 keeps only those columns.
    Callers apply the step-4 transpose; the magnitude front end takes
    ``|.|`` first and transposes one array instead of two.
    """
    n = x.shape[-1]
    n1, n2 = split_lanes(n)
    k1_out = n_out // n2
    cs2, tc, ts, c1s1 = _fourstep_tables(n, n_out, x.dtype, x.device)
    a = x.reshape(*x.shape[:-1], n2, n1)
    # Step 1: DFT over m2, cos and sin rows in one product.
    b = torch.matmul(cs2, a)
    br, bi = b[..., :n2, :], b[..., n2:, :]
    # Step 2: twiddle W_N^{k2*m1}.
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    # Step 3: DFT over m1 against the stacked [cos | sin] table.
    p = torch.matmul(cr, c1s1)
    q = torch.matmul(ci, c1s1)
    return p[..., :k1_out] - q[..., k1_out:], p[..., k1_out:] + q[..., :k1_out]


def _fourstep_magnitudes(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """|X[k]| for k < n_out by the four-step, in final bin order."""
    dr, di = _fourstep_pretranspose(x, n_out)
    # |.| before the step-4 transpose: one array through the layout pass.
    dm = torch.sqrt(dr**2 + di**2)
    return dm.transpose(-1, -2).reshape(*x.shape[:-1], n_out)


def _direct_dft_real(x: torch.Tensor, n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First ``n_out`` DFT bins of real ``x`` by one direct table product each."""
    c, s = _direct_tables(x.shape[-1], n_out, x.dtype, x.device)
    return torch.matmul(x, c), torch.matmul(x, s)


def fft_matmul_real(x: torch.Tensor, half: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex DFT of real ``x`` [..., N] as ``(re, im)``, by the four-step.

    ``half=True`` returns only the first N/2 bins (what the detectors and the
    cross spectra consume): step 3 then keeps only the columns those bins
    need.  N up to ``_DIRECT_DFT_MAX`` takes one direct table product.  The
    products run in IEEE float32 (``ieee_fp32_matmul``), against tables built
    in float64, and on the CPU on one thread (:func:`_one_cpu_thread`).
    """
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"four-step FFT requires power-of-two length, got {n}")
    n_out = n // 2 if half and n >= 2 else n
    with ieee_fp32_matmul(), _one_cpu_thread(x):
        if n <= _DIRECT_DFT_MAX:
            return _direct_dft_real(x, n_out)
        dr, di = _fourstep_pretranspose(x, n_out)
    # Step 4: k = k2 + n2*k1 -> transpose (k2, k1) -> (k1, k2) and flatten.
    lead = x.shape[:-1]
    return (dr.transpose(-1, -2).reshape(*lead, n_out),
            di.transpose(-1, -2).reshape(*lead, n_out))


@functools.lru_cache(maxsize=64)
def _packed_tables(n: int, dtype: torch.dtype, device: torch.device):
    """Operands of :func:`rfft_packed_matmul` at ``n``: the DFT tables of
    ``n1`` and ``n2`` (``n/2 = n1*n2``), the twiddles ``[n1, n2]`` and the
    untwist ``[n/2]``, each (cos, sin), on ``device``."""
    name = _dtype_name(dtype)
    n1, n2 = split_pow2(n // 2)
    host = (*_dft_tables(n1, name), *_dft_tables(n2, name), *_twiddle_tables(n1, n2, name),
            *_untwist_tables(n, name))
    return tuple(torch.tensor(t, device=device) for t in host)


def rfft_packed_matmul(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First N/2 DFT bins of real ``x`` [..., N] as ``(re, im)``, packed algorithm.

    Adjacent sample pairs form one complex sequence ``z[m] = x[2m] +
    i*x[2m+1]`` of length N/2, transformed by the four-step (N/2 = n1*n2) and
    untwisted::

        E[k] = (Z[k] + conj(Z[(N/2-k) mod N/2])) / 2
        O[k] = -i*(Z[k] - conj(Z[(N/2-k) mod N/2])) / 2
        X[k] = E[k] + W_N^k * O[k],   k = 0..N/2-1

    ``x`` reshaped to ``[n1, 2*n2]`` feeds step 1 directly: the even/odd
    split surfaces only in the output columns of the step-1 products.
    """
    n = x.shape[-1]
    if not is_pow2(n) or n < 4:
        raise ValueError(f"packed rfft requires power-of-two length >= 4, got {n}")
    nh = n // 2
    n1, n2 = split_pow2(nh)
    lead = x.shape[:-1]
    c1, s1, c2, s2, tc, ts, wc, ws = _packed_tables(n, x.dtype, x.device)
    # z[m] = x[2m] + i*x[2m+1], m = m2 + n2*m1.  u[m1, j] = x[j + 2*n2*m1]
    # (a free view): column j = 2*m2 + c holds component c of z[m2 + n2*m1].
    u = x.reshape(*lead, n1, 2 * n2)
    with ieee_fp32_matmul(), _one_cpu_thread(x):
        # Step 1: DFT over m1 for all interleaved columns at once.
        p = torch.matmul(c1, u)
        q = torch.matmul(s1, u)
        pr, pi = p[..., 0::2], p[..., 1::2]
        qr, qi = q[..., 0::2], q[..., 1::2]
        br = pr - qi  # Re(DFT_n1 z) = c1@zr - s1@zi
        bi = qr + pi  # Im(DFT_n1 z) = s1@zr + c1@zi
        # Step 2: twiddle W_{N/2}^{k1*m2}.
        cr = br * tc - bi * ts
        ci = br * ts + bi * tc
        # Step 3: DFT over m2 (complex), all n2 output columns.
        zr = torch.matmul(cr, c2) - torch.matmul(ci, s2)
        zi = torch.matmul(cr, s2) + torch.matmul(ci, c2)
    # Step 4: Z[k], k = k1 + n1*k2.
    zr = zr.transpose(-1, -2).reshape(*lead, nh)
    zi = zi.transpose(-1, -2).reshape(*lead, nh)
    # Untwist.  rev[k] = (N/2 - k) mod N/2 is a flip followed by a 1-roll.
    zr_rev = torch.roll(torch.flip(zr, dims=(-1,)), 1, dims=-1)
    zi_rev = torch.roll(torch.flip(zi, dims=(-1,)), 1, dims=-1)
    er = 0.5 * (zr + zr_rev)
    ei = 0.5 * (zi - zi_rev)
    our = 0.5 * (zi + zi_rev)
    oi = 0.5 * (zr_rev - zr)
    return er + wc * our - ws * oi, ei + wc * oi + ws * our


def full_spectrum(x: torch.Tensor, backend: str = "xla") -> torch.Tensor:
    """Full complex spectrum of real windows ``x`` [..., N], DC bin zeroed.

    The caller centres and pads (:func:`center_and_pad`); the DC bin is
    zeroed after the transform (reference ``fft_iterativa.py:85``).
    ``"xla"`` is ``torch.fft.fft``; ``"matmul"`` and ``"pallas"`` are
    :func:`fft_matmul_real`, as in the JAX package (its fused kernel
    computes magnitudes only).
    """
    if backend == "xla":
        cdtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
        spec = torch.fft.fft(x.to(cdtype))
    elif backend in ("matmul", "pallas"):
        spec = torch.complex(*fft_matmul_real(x))
    else:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {BACKENDS}")
    spec[..., 0] = 0
    return spec


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
        with ieee_fp32_matmul(), _one_cpu_thread(x):
            if n <= _DIRECT_DFT_MAX:
                re, im = _direct_dft_real(x, n // 2)
                mags = torch.sqrt(re**2 + im**2)
            else:
                mags = _fourstep_magnitudes(x, n // 2)
    elif backend == "pallas":
        from apda_fft_tpu_torch.ops.fft_cuda import halfspec_magnitudes_fused

        return halfspec_magnitudes_fused(x)
    else:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {BACKENDS}")
    mags[..., 0] = 0
    return mags
