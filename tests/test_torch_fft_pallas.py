"""The port's fused front end (``backend="pallas"``) against the JAX package's.

On a CPU tensor ``fft_cuda.halfspec_magnitudes_fused`` runs its plain torch
twin; it is held here against the JAX package's Pallas kernel
``halfspec_magnitudes_pallas`` in interpret mode: within 3e-6 of the row
scale (the JAX package's own tolerance for its kernel), and <= 1e-6
normwise against float64 ``numpy.fft`` (the spectrum contract).  Epochs with
``backend="pallas"`` are held against the JAX package's: decisions equal,
values to the reference's rounding.  The CUDA kernel needs the card:
``test_torch_gpu_card.py`` and ``chip_smoke.py`` compare it with the twin
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu.ops.fft_pallas import halfspec_magnitudes_pallas
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.ops import fft as tfft
from apda_fft_tpu_torch.ops import fft_cuda, latency_cuda
from tests.signals import modal_signal
from tests.test_torch_pipeline import _assert_epoch_equal

FS = 500.0


@pytest.fixture(autouse=True)
def _fresh_dynamic_state():
    def reset():
        jpipe._dynamic_budget.clear()
        jpipe._dynamic_budget_hwm.clear()
        jpipe._dynamic_tier.clear()
        tpipe.reset_dynamic_state()

    reset()
    yield
    reset()


def _windows(b, n, seed):
    """Mean-centred float32 windows: modal rows and one noise row."""
    rng = np.random.default_rng(seed)
    x = np.stack([modal_signal(n, FS, seed=seed + i) for i in range(b - 1)]
                 + [rng.standard_normal(n)])
    return (x - x.mean(axis=-1, keepdims=True)).astype(np.float32)


def _float64_mags(x):
    ref = np.abs(np.fft.rfft(x.astype(np.float64))[:, : x.shape[-1] // 2])
    ref[:, 0] = 0.0
    return ref


@pytest.mark.parametrize("n", [64, 256, 1024, 4096])
def test_plain_matches_pallas_interpret(n):
    x = _windows(5, n, seed=n)
    before = fft_cuda.launches
    got = fft_cuda.halfspec_magnitudes_fused(torch.from_numpy(x))
    assert fft_cuda.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == torch.float32 and got.shape == (5, n // 2)
    assert float(got[:, 0].abs().max()) == 0.0
    # block_windows=4 does not divide B=5: the JAX wrapper pads the batch.
    want = np.asarray(halfspec_magnitudes_pallas(jnp.asarray(x), block_windows=4,
                                                 interpret=True))
    scale = want.max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6, rtol=0)
    ref = _float64_mags(x)
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= 1e-6


def test_backend_pallas_dispatches_to_the_fused_front_end():
    x = torch.from_numpy(_windows(3, 512, seed=1))
    np.testing.assert_array_equal(tfft.halfspec_magnitudes(x, backend="pallas").numpy(),
                                  fft_cuda._halfspec_magnitudes_fused_plain(x).numpy())


def test_casts_to_float32_and_empty_batch():
    x = _windows(2, 256, seed=3)
    got = fft_cuda.halfspec_magnitudes_fused(torch.from_numpy(x.astype(np.float64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), fft_cuda.halfspec_magnitudes_fused(torch.from_numpy(x)).numpy())
    assert fft_cuda.halfspec_magnitudes_fused(torch.zeros((0, 128))).shape == (0, 64)


def test_validation_errors():
    with pytest.raises(ValueError, match=r"expected \[B, N\] windows"):
        fft_cuda.halfspec_magnitudes_fused(torch.zeros(256))
    with pytest.raises(ValueError, match=r"expected \[B, N\] windows"):
        fft_cuda.halfspec_magnitudes_fused(torch.zeros((2, 3, 256)))
    with pytest.raises(ValueError, match="power of two >= 64"):
        fft_cuda.halfspec_magnitudes_fused(torch.zeros((2, 32)))
    with pytest.raises(ValueError, match="power of two >= 64"):
        fft_cuda.halfspec_magnitudes_fused(torch.zeros((2, 96)))
    with pytest.raises(TypeError, match="torch.Tensor"):
        fft_cuda.halfspec_magnitudes_fused(np.zeros((2, 256), np.float32))
    with pytest.raises(ValueError, match="power of two >= 64"):
        tpipe.analyze_epoch(np.zeros((2, 32), np.float32), FS, backend="pallas",
                            max_candidates=4, device="cpu")


def test_tables_are_the_latency_kernels():
    """The single-window kernels run this kernel's FFT on its twiddle table."""
    assert latency_cuda._twiddle_table is fft_cuda._twiddle_table


@pytest.mark.parametrize("mode", ["flexible", "rigid", "adaptive"])
def test_epoch_matches_jax_pallas_backend(mode):
    x = _windows(4, 1024, seed=20) + np.float32(0.5)
    want = jpipe.analyze_epoch(jnp.asarray(x), FS, mode=mode, backend="pallas",
                               lowlat="never", refine=True, dtype=jnp.float32)
    got = tpipe.analyze_epoch(x, FS, mode=mode, backend="pallas", lowlat="never",
                              refine=True, device="cpu")
    _assert_epoch_equal(got, want)
    assert int(got.count.min()) > 0


def test_chunks_take_the_fused_front_end(monkeypatch):
    calls = []
    real = fft_cuda.halfspec_magnitudes_fused

    def counting(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(fft_cuda, "halfspec_magnitudes_fused", counting)
    x = _windows(6, 512, seed=30)
    got = tpipe.analyze_epoch(x, FS, backend="pallas", batch_chunk=4, device="cpu")
    assert calls and all(c == (4, 512) for c in calls)
    want = tpipe.analyze_epoch(x, FS, backend="matmul", batch_chunk=4, device="cpu")
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy())


def test_one_window_takes_the_batched_path(monkeypatch):
    """As in the JAX package, only the matmul backend is routed to the
    single-window kernels: with a (faked) card, ``backend="pallas"`` on one
    window runs the fused front end and never the latency kernel."""
    def no_latency_kernel(*args, **kwargs):
        raise AssertionError("backend='pallas' reached the latency kernel")

    monkeypatch.setattr(tpipe, "_lowlat_device", lambda samples: True)
    monkeypatch.setattr(latency_cuda, "analyze_window_lowlat", no_latency_kernel)
    monkeypatch.setattr(latency_cuda, "_route_pass", no_latency_kernel)
    x = _windows(2, 1024, seed=40)[:1]
    got = tpipe.analyze_epoch(x, FS, backend="pallas", refine=True, device="cpu")
    want = tpipe.analyze_epoch(x, FS, backend="matmul", lowlat="never", refine=True,
                               device="cpu")
    _assert_epoch_equal(got, want)
