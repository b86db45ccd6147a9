"""The port's single-window latency route against the JAX package's, on the CPU.

On a CPU tensor ``analyze_window_lowlat`` runs its plain torch version; it
is held here against the JAX package's fused Pallas kernels in interpret
mode.  Decisions (``count``, ``idx``, ``n_candidates``, ``n_required``) are
equal; ``freq``/``mag`` to one 4-dp rounding step (float32 can land on the
other side of a tie), ``damping``/``q`` to one 2-dp step, ``refined_freq``
within 1e-3 Hz, as the JAX package's own test holds its kernel to its
batched path.  The CUDA kernels need the card: ``test_torch_gpu_card.py``
and ``chip_smoke.py`` compare them with the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import latency_pallas as jlat
from apda_fft_tpu_torch.ops import fft_cuda
from apda_fft_tpu_torch.ops import latency_cuda as tlat
from apda_fft_tpu_torch.ops.fft import split_pow2
from tests.oracle import oracle_analyze
from tests.signals import modal_signal


def _window(n, fs, seed, kind="modal"):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    if kind == "modal":
        x = (
            np.sin(2 * np.pi * 0.025 * fs * t)
            + 0.6 * np.sin(2 * np.pi * 0.095 * fs * t)
            + 0.05 * rng.standard_normal(n)
            + 3.0
        )
    elif kind == "noise":
        x = rng.standard_normal(n)
    elif kind == "flat":
        x = np.full(n, 2.5)
    else:  # sparse impulses
        x = np.zeros(n)
        x[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    return x.astype(np.float32)


def _assert_same(got, want):
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("freq", "mag"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=1e-6, err_msg=f)
    for f in ("damping", "q_factor"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-2, rtol=0, err_msg=f)
    np.testing.assert_allclose(got.refined_freq.numpy(), np.asarray(want.refined_freq),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
@pytest.mark.parametrize("kind", ["modal", "noise", "impulse"])
def test_plain_matches_pallas_interpret(mode, kind):
    n, fs = 1024, 500.0
    x = _window(n, fs, seed=7, kind=kind)
    before = dict(tlat.launches)
    got = tlat.analyze_window_lowlat(torch.from_numpy(x), fs, mode=mode, refine=True,
                                     max_candidates=16)
    want = jlat.analyze_window_lowlat(jnp.asarray(x), jnp.float32(fs), mode=mode, refine=True,
                                      max_candidates=16, interpret=True)
    _assert_same(got, want)
    assert got.idx.shape == (1, 5 if mode == "rigid" else 4)
    if mode == "rigid":
        assert not got.prominence.any() and not got.damping.any() and not got.q_factor.any()
        assert int(got.n_required[0]) == 0
    assert tlat.launches == before  # CPU tensors never launch a kernel


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
@pytest.mark.parametrize("n, fs, seed", [(1024, 500.0, 0), (2048, 62.5, 6)])
def test_decisions_match_float64_oracle(mode, n, fs, seed):
    x = modal_signal(n, fs, seed=seed).astype(np.float32)
    ref = oracle_analyze(x, fs, mode=mode)
    res = tlat.analyze_window_lowlat(torch.from_numpy(x), fs, n_fft=n, mode=mode,
                                     max_candidates=16)
    assert int(res.n_candidates[0]) <= 16
    c = int(res.count[0])
    assert res.idx[0, :c].tolist() == [p["idx"] for p in ref]


def test_flat_window_has_no_candidates():
    res = tlat.analyze_window_lowlat(torch.from_numpy(_window(256, 500.0, 0, "flat")), 500.0,
                                     mode="flexible", refine=True)
    assert int(res.count[0]) == 0 and int(res.n_candidates[0]) == 0
    assert res.idx.tolist() == [[-1] * 4] and not res.refined_freq.any()


def test_validation_errors():
    x = torch.zeros(1024)
    with pytest.raises(ValueError, match="exactly one window"):
        tlat.analyze_window_lowlat(torch.zeros(2, 1024), 500.0)
    with pytest.raises(ValueError, match="full window"):
        tlat.analyze_window_lowlat(torch.zeros(1000), 500.0, n_fft=1024)
    with pytest.raises(ValueError, match="power of two"):
        tlat.analyze_window_lowlat(torch.zeros(48), 500.0, n_fft=48)
    with pytest.raises(ValueError, match="unknown mode"):
        tlat.analyze_window_lowlat(x, 500.0, mode="adaptive")
    with pytest.raises(ValueError, match=r"\[N\] or \[1, N\]"):
        tlat.analyze_window_lowlat(torch.zeros(1, 1, 1024), 500.0)


def test_budget_overflow_reported():
    # Pure noise has many threshold-crossing maxima; a tiny budget truncates
    # and must report the true pre-budget count for the caller's re-run.
    x = _window(1024, 500.0, seed=3, kind="noise")
    lo = tlat.analyze_window_lowlat(torch.from_numpy(x), 500.0, mode="flexible",
                                    max_candidates=2)
    assert int(lo.n_candidates[0]) > 2
    assert int(lo.n_required[0]) > 2


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_tables_bit_equal_to_jax(n):
    """The four-step tables of the plain twin's front end (the kernels now
    run an FFT on ``fft_cuda._twiddle_table``) are the JAX kernel's bits."""
    n1, n2 = split_pow2(n)
    assert (n1, n2) == jlat._latency_split(n)
    for got, want in zip(fft_cuda._tables(n1, n2), jlat._tables(n1, n2)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
