"""The port's numpy table builders and batched statistics against the JAX package.

The port re-states the JAX package's float64 table builders instead of
importing them (importing ``apda_fft_tpu`` imports JAX); these tests hold the
copies bit-equal.  Statistics use float32 inputs made with numpy and
compare at rtol 1e-6 (the two frameworks sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import fft as jfft
from apda_fft_tpu.ops import peaks_resolution as jres
from apda_fft_tpu.ops import stats as jstats
from apda_fft_tpu_torch.ops import fft as tfft
from apda_fft_tpu_torch.ops import peaks_resolution as tres
from apda_fft_tpu_torch.ops import stats as tstats


@pytest.mark.parametrize("n", [1, 2, 8, 32, 128, 512, 1024])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dft_tables_bit_equal(n, dtype):
    for a, b in zip(jfft._dft_tables(n, dtype), tfft._dft_tables(n, dtype)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n1,n2", [(4, 2), (32, 128), (128, 32), (256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_twiddle_tables_bit_equal(n1, n2, dtype):
    for a, b in zip(jfft._twiddle_tables(n1, n2, dtype), tfft._twiddle_tables(n1, n2, dtype)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 3, 64, 1000, 1024, 4096, 65536, 131072])
def test_size_helpers_match(n):
    assert tfft.next_pow2(n) == jfft.next_pow2(n)
    assert tfft.is_pow2(n) == jfft.is_pow2(n)
    if jfft.is_pow2(n) and n > 1:
        assert tfft.split_pow2(n) == jfft.split_pow2(n)
        assert tfft.split_lanes(n) == jfft.split_lanes(n)


@pytest.mark.parametrize("fs", [500.0, 250.0, 100.3, 333.0, 1000.0 / 3.0])
@pytest.mark.parametrize("n_fft", [32, 1024, 8192])
def test_rigid_half_corrections_bit_equal(fs, n_fft):
    a, b = jres.rigid_half_corrections(fs, n_fft), tres.rigid_half_corrections(fs, n_fft)
    if a is None:
        assert b is None
    else:
        assert b is not None and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3.0 + 1.0


@pytest.mark.parametrize("n", [63, 64, 257])
def test_median_full_rows(n):
    x = _rows((7, n), seed=n)
    want = np.asarray(jstats.median_lastaxis(jnp.asarray(x)))
    got = tstats.median_lastaxis(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # statistics.median semantics: the mean of the two middle values.
    np.testing.assert_allclose(got, np.median(x, axis=-1), rtol=1e-6)


def test_median_ragged_lengths():
    x = _rows((9, 100), seed=3)
    lengths = np.random.default_rng(4).integers(1, 101, size=9).astype(np.int32)
    want = np.asarray(jstats.median_lastaxis(jnp.asarray(x), jnp.asarray(lengths)))
    got = tstats.median_lastaxis(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref = [np.median(row[:n]) for row, n in zip(x, lengths)]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("n", [32, 2048])
def test_mean_std_and_threshold_match_jax(n):
    x = np.abs(_rows((11, n), seed=n + 1))
    jm, js = jstats.mean_std_ddof1(jnp.asarray(x))
    tm, ts = tstats.mean_std_ddof1(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    jt, _ = jstats.noise_threshold(jnp.asarray(x))
    tt, _ = tstats.noise_threshold(torch.from_numpy(x))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.std(x.astype(np.float64), axis=-1, ddof=1),
                               rtol=1e-6)


def test_div_exact_is_true_division():
    x = torch.tensor([1.0, 3.0, 7.0, 1e-3], dtype=torch.float32)
    np.testing.assert_array_equal(
        tstats.div_exact(x, 3.0).numpy(), (x.numpy() / np.float32(3.0)).astype(np.float32)
    )
