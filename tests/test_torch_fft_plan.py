"""The plan of the front-end kernel ``csrc/halfspec_fused.cu``, in numpy.

The kernel runs only on the card.  Its plan is modelled here step for step
in float32: the pack of a real row into N/2 complex points, the Stockham
passes (one radix-2 or radix-4 pass when log2(N/2) is not a multiple of 3,
then radix 8) with their twiddles read from the same float32 table
(``fft_cuda._twiddle_table``), the same in-register DFTs, then the split
into the real transform's magnitudes.  The model must be within 1e-6
normwise of float64 ``numpy.fft`` (the spectrum contract), so an index or
table mistake in the plan shows here before it reaches the card.  The
flexible single-window kernel (``csrc/lowlat_window.cu``) runs the same plan
(``csrc/fft_common.cuh``) on a raw window, after a pack that subtracts the
window's float32 mean from every sample; the model covers that pack too.
"""

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.ops import fft_cuda

NS = (64, 256, 1024, 4096, 65536)
SQRT_HALF = np.float32(0.70710678118654752)


def _radices(l: int) -> list[int]:
    rem = (l.bit_length() - 1) % 3
    return ([1 << rem] if rem else []) + [8] * ((l.bit_length() - 1) // 3)


def _dft4(a0, a1, a2, a3):
    s02, d02 = a0 + a2, a0 - a2
    s13, d13 = a1 + a3, -1j * (a1 - a3)
    return [s02 + s13, d02 + d13, s02 - s13, d02 - d13]


def _dft(v: list[np.ndarray]) -> list[np.ndarray]:
    """The kernel's in-register DFTs on complex64 columns, natural order."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        return _dft4(*v)
    e = _dft4(v[0], v[2], v[4], v[6])
    o = _dft4(v[1], v[3], v[5], v[7])
    o[1] = SQRT_HALF * (o[1].real + o[1].imag) + 1j * (SQRT_HALF * (o[1].imag - o[1].real))
    o[2] = -1j * o[2]
    o[3] = SQRT_HALF * (o[3].imag - o[3].real) - 1j * (SQRT_HALF * (o[3].real + o[3].imag))
    o = [oi.astype(np.complex64) for oi in o]
    return [e[r] + o[r] for r in range(4)] + [e[r] - o[r] for r in range(4)]


def _twiddle(t: np.ndarray, e: np.ndarray, l: int) -> np.ndarray:
    """W_n^e for 0 <= e < n = 2l from the table of W_n^k, k < l."""
    return np.where(e < l, t[e % l], -t[e % l]).astype(np.complex64)


def kernel_plan(x: np.ndarray, table: np.ndarray, mean: np.ndarray | None = None) -> np.ndarray:
    """The kernel's arithmetic on ``x [B, n]`` float32 in complex64; with
    ``mean [B, 1]`` float32 the pack first subtracts it (rounded)."""
    b, n = x.shape
    l = n // 2
    t = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
    if mean is not None:
        x = (x - mean).astype(np.float32)
    src = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    ns = 1
    for r_ in _radices(l):
        nb = l // r_
        step = 2 * l // (ns * r_)
        bfly = np.arange(nb)
        k = bfly & (ns - 1)
        v = [src[:, bfly + r * nb] for r in range(r_)]
        if ns > 1:  # the first pass's twiddles are all W^0 = 1
            v = [v[0]] + [v[r] * _twiddle(t, r * k * step, l) for r in range(1, r_)]
        v = _dft([vi.astype(np.complex64) for vi in v])
        dst = np.empty_like(src)
        d = (bfly - k) * r_ + k
        for r in range(r_):
            dst[:, d + r * ns] = v[r]
        src, ns = dst, ns * r_
    z = src
    k = np.arange(1, l // 2 + 1)
    za, zb = z[:, k], z[:, l - k]
    half = np.float32(0.5)
    er, ei = half * (za.real + zb.real), half * (za.imag - zb.imag)
    orr, oi = half * (za.real - zb.real), half * (za.imag + zb.imag)
    w = t[k]
    pr = w.real * orr - w.imag * oi
    pi = w.real * oi + w.imag * orr
    out = np.zeros((b, l), np.float32)
    out[:, l - k] = np.sqrt((er - pi) ** 2 + (ei + pr) ** 2)
    out[:, k] = np.sqrt((er + pi) ** 2 + (ei - pr) ** 2)
    return out


def _windows(n: int, kind: str, b: int = 3) -> np.ndarray:
    rng = np.random.default_rng(n + len(kind))
    t = np.arange(n) / 500.0
    if kind == "modal":
        x = (np.sin(2 * np.pi * 12.5 * t) + 0.6 * np.sin(2 * np.pi * 47.5 * t + 1.0)
             + 0.05 * rng.standard_normal((b, n)))
    elif kind == "noise":
        x = rng.standard_normal((b, n))
    elif kind == "impulse":
        x = np.zeros((b, n))
        for row in x:
            row[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    else:
        x = np.full((b, n), 2.5) + np.arange(b)[:, None]
    return (x - x.mean(axis=-1, keepdims=True)).astype(np.float32)


def _float64_mags(x: np.ndarray) -> np.ndarray:
    ref = np.abs(np.fft.rfft(x.astype(np.float64))[:, : x.shape[-1] // 2])
    ref[:, 0] = 0.0
    return ref


@pytest.mark.parametrize("kind", ["modal", "noise", "impulse", "flat"])
@pytest.mark.parametrize("n", NS)
def test_plan_matches_float64_fft(n, kind):
    x = _windows(n, kind, b=2 if n > 4096 else 3)
    got = kernel_plan(x, fft_cuda._twiddle_table(n).numpy())
    assert got.shape == (x.shape[0], n // 2) and not got[:, 0].any()
    ref = _float64_mags(x)
    if not ref.any():
        # A centred constant row: every bin is rounding noise.
        assert np.abs(got).max() <= 1e-5
        return
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6


@pytest.mark.parametrize("kind", ["modal", "noise", "impulse"])
@pytest.mark.parametrize("n", NS)
def test_centred_plan_matches_float64_fft(n, kind):
    """A raw window with an offset, as the single-window kernel takes it:
    its float32 mean (a float32 sum over n) leaves the pack, then the plan
    runs as above; held against float64 ``numpy.fft`` of the window centred
    in float64."""
    x = (_windows(n, kind, b=2) + np.float32(3.0)).astype(np.float32)
    mean = (x.sum(axis=-1, dtype=np.float32, keepdims=True) / np.float32(n)).astype(np.float32)
    got = kernel_plan(x, fft_cuda._twiddle_table(n).numpy(), mean=mean)
    ref = _float64_mags(x.astype(np.float64) - x.mean(axis=-1, keepdims=True, dtype=np.float64))
    assert not got[:, 0].any()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6


@pytest.mark.parametrize("n", NS)
def test_plan_radices_cover_the_transform(n):
    radices = _radices(n // 2)
    assert int(np.prod(radices)) == n // 2
    assert all(r == 8 for r in radices[1:]) and radices[0] in (2, 4, 8)


@pytest.mark.parametrize("n", NS)
def test_twiddle_table_is_float64_cast_once(n):
    t = fft_cuda._twiddle_table(n)
    assert t.dtype == torch.float32 and t.shape == (n // 2, 2)
    want = np.exp(-2j * np.pi * np.arange(n // 2, dtype=np.float64) / n)
    np.testing.assert_array_equal(t[:, 0].numpy(), want.real.astype(np.float32))
    np.testing.assert_array_equal(t[:, 1].numpy(), want.imag.astype(np.float32))
    assert fft_cuda._twiddle_table(n) is t  # cached per (n, device)


def test_plan_reads_the_table_at_every_twiddle_it_needs():
    """The pass twiddles W_n^e, e < n, fold onto the half table exactly."""
    n = 256
    t64 = np.exp(-2j * np.pi * np.arange(n) / n)
    table = fft_cuda._twiddle_table(n).numpy()
    t = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
    got = _twiddle(t, np.arange(n), n // 2)
    np.testing.assert_allclose(got, t64, atol=1e-7, rtol=0)
