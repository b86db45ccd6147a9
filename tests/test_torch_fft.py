"""The port's spectral front end against float64 numpy.fft and the JAX package.

Spectra: <= 1e-6 normwise against float64 ``numpy.fft`` (the repo's spectrum
contract) and <= 2e-6 normwise against the JAX package's matmul backend (two
float32 computations, each within 1e-6 of the truth).
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import fft as jfft
from apda_fft_tpu_torch.ops import fft as tfft


def _windows(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("backend", ["matmul", "xla", "pallas"])
def test_halfspec_accuracy(n, backend):
    x = _windows(6, n, seed=n)
    ref = np.abs(np.fft.rfft(x.astype(np.float64))[:, : n // 2])
    ref[:, 0] = 0.0
    got = tfft.halfspec_magnitudes(torch.from_numpy(x), backend=backend)
    assert got.dtype == torch.float32 and got.shape == (6, n // 2)
    assert float(got[:, 0].abs().max()) == 0.0
    assert _normwise(got.numpy(), ref) <= 1e-6
    jax_mags = np.asarray(jfft.halfspec_magnitudes(jnp.asarray(x), backend="matmul"))
    assert _normwise(got.numpy(), jax_mags) <= 2e-6


def test_halfspec_leading_batch_shape():
    x = _windows(6, 1024, seed=1).reshape(2, 3, 1024)
    got = tfft.halfspec_magnitudes(torch.from_numpy(x))
    flat = tfft.halfspec_magnitudes(torch.from_numpy(x.reshape(6, 1024)))
    assert got.shape == (2, 3, 512)
    np.testing.assert_allclose(got.reshape(6, 512).numpy(), flat.numpy(), rtol=1e-6, atol=1e-5)


def test_halfspec_rejects_unported_modes():
    x = torch.zeros((2, 256))
    with pytest.raises(NotImplementedError, match="fast"):
        tfft.halfspec_magnitudes(x, precision="fast")
    with pytest.raises(ValueError, match="unknown FFT backend"):
        tfft.halfspec_magnitudes(x, backend="cufft")
    with pytest.raises(ValueError, match="unknown precision"):
        tfft.halfspec_magnitudes(x, precision="low")


#: Every float32 precision setting the IEEE guard pins, with a non-IEEE value
#: a caller might hold: cuBLAS and oneDNN matmuls, cuDNN and oneDNN
#: convolutions.
_KNOBS = ((torch.backends.cuda.matmul, "tf32"), (torch.backends.mkldnn.matmul, "bf16"),
          (torch.backends.cudnn.conv, "tf32"), (torch.backends.mkldnn.conv, "tf32"))


def _precisions():
    return [k.fp32_precision for k, _ in _KNOBS]


def test_ieee_matmul_restores_the_callers_setting():
    saved = _precisions()
    try:
        for k, v in _KNOBS:
            k.fp32_precision = v
        with tfft.ieee_fp32_matmul():
            assert _precisions() == ["ieee"] * len(_KNOBS)
            with tfft.ieee_fp32_matmul():  # nested: still pinned, restored once
                assert _precisions() == ["ieee"] * len(_KNOBS)
            assert _precisions() == ["ieee"] * len(_KNOBS)
        assert _precisions() == [v for _, v in _KNOBS]
    finally:
        for (k, _), v in zip(_KNOBS, saved):
            k.fp32_precision = v


def test_ieee_matmul_overlapping_calls_restore_once():
    """Two overlapping calls (as from two threads) that leave in the order
    they entered: the override holds until the last one leaves, and the
    caller's settings come back, not the override."""
    saved = _precisions()
    try:
        for k, v in _KNOBS:
            k.fp32_precision = v
        first, second = tfft.ieee_fp32_matmul(), tfft.ieee_fp32_matmul()
        first.__enter__()
        second.__enter__()
        first.__exit__(None, None, None)
        assert _precisions() == ["ieee"] * len(_KNOBS)
        second.__exit__(None, None, None)
        assert _precisions() == [v for _, v in _KNOBS]
    finally:
        for (k, _), v in zip(_KNOBS, saved):
            k.fp32_precision = v


def test_ieee_matmul_thread_stress():
    """More threads than cores enter and leave the override at random
    moments: inside, every setting is always IEEE; once all have left, the
    caller's settings are back."""
    saved, interval = _precisions(), sys.getswitchinterval()
    seen = []

    def work():
        for _ in range(200):
            with tfft.ieee_fp32_matmul():
                seen.append(tuple(_precisions()))

    try:
        for k, v in _KNOBS:
            k.fp32_precision = v
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(seen) == 200 * len(threads) and set(seen) == {("ieee",) * len(_KNOBS)}
        assert _precisions() == [v for _, v in _KNOBS]
    finally:
        sys.setswitchinterval(interval)
        for (k, _), v in zip(_KNOBS, saved):
            k.fp32_precision = v


def test_ieee_guard_keeps_a_convolution_in_float32():
    """A float32 ``conv1d`` inside the guard equals the float64 convolution
    to float32 rounding (the resampling filters' contract), on the CPU."""
    rng = np.random.default_rng(4)
    x, w = rng.standard_normal((4, 1, 3000)), rng.standard_normal((1, 1, 97))
    with tfft.ieee_fp32_matmul():
        got = torch.nn.functional.conv1d(torch.from_numpy(x).float(),
                                         torch.from_numpy(w).float(), stride=3)
    want = torch.nn.functional.conv1d(torch.from_numpy(x), torch.from_numpy(w), stride=3)
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-6


def test_halfspec_multithreaded_cpu_matches_one_thread():
    """The CPU front end at 8 intra-op threads, repeated, row by row against
    one thread: each thread computes a block of windows, so a fault confined
    to one thread's block shows as a few rows off."""
    rng = np.random.default_rng(42)
    t = np.arange(4096) / 500.0
    base = np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
    x = torch.from_numpy((base + 0.05 * rng.standard_normal((256, 4096))).astype(np.float32))
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = tfft.halfspec_magnitudes(x).numpy()
        torch.set_num_threads(8)
        for _ in range(5):
            got = tfft.halfspec_magnitudes(x).numpy()
            rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
            assert rows.max() <= 1e-6, np.flatnonzero(rows > 1e-6)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_center_and_pad_matches_jax(with_lengths):
    x = _windows(5, 700, seed=2) * 2.0 + 3.0
    lengths = np.array([700, 1, 2, 350, 699], np.int32) if with_lengths else None
    want = np.asarray(jfft.center_and_pad(
        jnp.asarray(x), 1024, None if lengths is None else jnp.asarray(lengths)))
    got = tfft.center_and_pad(
        torch.from_numpy(x), 1024, None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == (5, 1024)
    np.testing.assert_array_equal(got.numpy(), want)


def test_center_and_pad_validates():
    with pytest.raises(ValueError, match="power of two"):
        tfft.center_and_pad(torch.zeros((1, 8)), 12)
    with pytest.raises(ValueError, match="exceeds"):
        tfft.center_and_pad(torch.zeros((1, 20)), 16)


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman"])
def test_taper_window_matches_jax(name):
    want = np.asarray(jfft.taper_window(name, 256, jnp.float32))
    got = tfft.taper_window(name, 256, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    lengths = np.array([256, 100, 1, 2], np.int32)
    want = np.asarray(jfft.taper_window(name, 256, jnp.float32, jnp.asarray(lengths)))
    got = tfft.taper_window(name, 256, torch.float32, torch.from_numpy(lengths))
    assert got.shape == (4, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_taper_window_validates():
    with pytest.raises(ValueError, match="unknown taper"):
        tfft.taper_window("kaiser", 16)
    with pytest.raises(ValueError, match="skip tapering"):
        tfft.taper_window("none", 16)
