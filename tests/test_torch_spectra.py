"""The port's complex spectra against float64 numpy.fft and the JAX package.

``fft_matmul_real`` (all bins and the first half), ``rfft_packed_matmul``
and ``full_spectrum`` on the same float32 windows: <= 1e-6 normwise against
float64 ``numpy.fft`` (the spectrum contract), and element by element within
2e-6 of the row maximum of the JAX package's function (two float32
computations that sum in different orders).  The magnitude front end, which
now shares the four-step's steps 1-3 with the complex path, keeps its bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import fft as jfft
from apda_fft_tpu_torch.ops import fft as tfft

NS = [64, 512, 1024, 4096, 16384]


def _windows(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _near_jax(got: np.ndarray, want: np.ndarray):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2e-6 * scale).all(), float((np.abs(got - want) / scale).max())


def _complex(pair):
    re, im = pair
    return np.asarray(re).astype(np.float64) + 1j * np.asarray(im).astype(np.float64)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("half", [False, True])
def test_fft_matmul_real(n, half):
    x = _windows(3, n, seed=n + half)
    got = _complex(tfft.fft_matmul_real(torch.from_numpy(x), half=half))
    n_out = n // 2 if half else n
    assert got.shape == (3, n_out)
    ref = np.fft.fft(x.astype(np.float64))[:, :n_out]
    assert _normwise(got, ref) <= 1e-6
    _near_jax(got, _complex(jfft.fft_matmul_real(jnp.asarray(x), half=half)))


@pytest.mark.parametrize("n", NS)
def test_rfft_packed_matmul(n):
    x = _windows(3, n, seed=2 * n)
    got = _complex(tfft.rfft_packed_matmul(torch.from_numpy(x)))
    assert got.shape == (3, n // 2)
    assert _normwise(got, np.fft.rfft(x.astype(np.float64))[:, : n // 2]) <= 1e-6
    _near_jax(got, _complex(jfft.rfft_packed_matmul(jnp.asarray(x))))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_full_spectrum(n, backend):
    x = _windows(3, n, seed=3 * n)
    got = tfft.full_spectrum(torch.from_numpy(x), backend)
    assert got.dtype == torch.complex64 and got.shape == (3, n)
    got = got.numpy()
    assert not got[:, 0].any()
    ref = np.fft.fft(x.astype(np.float64))
    ref[:, 0] = 0
    assert _normwise(got, ref) <= 1e-6
    _near_jax(got, np.asarray(jfft.full_spectrum(jnp.asarray(x), backend)))


def test_full_spectrum_pallas_is_the_four_step_and_keeps_shapes():
    x = _windows(6, 1024, seed=4).reshape(2, 3, 1024)
    got = tfft.full_spectrum(torch.from_numpy(x), "pallas")
    assert got.shape == (2, 3, 1024)
    assert torch.equal(got, tfft.full_spectrum(torch.from_numpy(x), "matmul"))
    flat = tfft.full_spectrum(torch.from_numpy(x.reshape(6, 1024)), "matmul")
    np.testing.assert_allclose(got.reshape(6, 1024).numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-5)
    spec = tfft.full_spectrum(torch.from_numpy(x.astype(np.float64)), "xla")
    assert spec.dtype == torch.complex128


def test_validation_errors():
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.fft_matmul_real(torch.zeros((2, 96)))
    with pytest.raises(ValueError, match="power-of-two length >= 4"):
        tfft.rfft_packed_matmul(torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="power-of-two length >= 4"):
        tfft.rfft_packed_matmul(torch.zeros((2, 48)))
    with pytest.raises(ValueError, match="unknown FFT backend"):
        tfft.full_spectrum(torch.zeros((2, 64)), "cufft")


@pytest.mark.parametrize("n", [4, 64, 1024, 4096, 65536])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_untwist_tables_bit_equal_to_jax(n, dtype):
    for got, want in zip(tfft._untwist_tables(n, dtype), jfft._untwist_tables(n, dtype)):
        assert got.dtype == want.dtype and got.shape == (n // 2,)
        np.testing.assert_array_equal(got, want)


def _magnitudes_before(x: torch.Tensor) -> torch.Tensor:
    """The matmul magnitude front end as it was before the complex path
    shared its steps 1-3 (verbatim), the reference for the bits."""
    n = x.shape[-1]
    n_out = n // 2
    with tfft.ieee_fp32_matmul():
        if n <= tfft._DIRECT_DFT_MAX:
            c, s = tfft._direct_tables(n, n_out, x.dtype, x.device)
            mags = torch.sqrt(torch.matmul(x, c) ** 2 + torch.matmul(x, s) ** 2)
        else:
            lead = x.shape[:-1]
            n1, n2 = tfft.split_lanes(n)
            k1_out = n_out // n2
            cs2, tc, ts, c1s1 = tfft._fourstep_tables(n, n_out, x.dtype, x.device)
            a = x.reshape(*lead, n2, n1)
            b = torch.matmul(cs2, a)
            br, bi = b[..., :n2, :], b[..., n2:, :]
            cr = br * tc - bi * ts
            ci = br * ts + bi * tc
            p = torch.matmul(cr, c1s1)
            q = torch.matmul(ci, c1s1)
            dr = p[..., :k1_out] - q[..., k1_out:]
            di = p[..., k1_out:] + q[..., :k1_out]
            dm = torch.sqrt(dr**2 + di**2)
            mags = dm.transpose(-1, -2).reshape(*lead, n_out)
    mags[..., 0] = 0
    return mags


@pytest.mark.parametrize("n", NS)
def test_magnitude_front_end_keeps_its_bits(n):
    x = torch.from_numpy(_windows(5, n, seed=5 * n)).reshape(5, 1, n)
    assert torch.equal(tfft.halfspec_magnitudes(x, backend="matmul"), _magnitudes_before(x))
