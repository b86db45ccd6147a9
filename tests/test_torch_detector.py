"""The port's detectors against the JAX package's, on the CPU.

On a CPU tensor the select+scan wrapper runs its plain torch version; it is
held here against the JAX package's fused Pallas kernel in interpret mode
and its staged XLA path (integers exact, floats to rtol 1e-6 - the
frameworks reduce in different orders).  The CUDA kernel itself needs the
card: ``test_torch_gpu_card.py`` and ``chip_smoke.py`` phase 3 compare it
with the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import peaks_prominence as jprom
from apda_fft_tpu.ops import peaks_resolution as jres
from apda_fft_tpu.ops.detector_pallas import (
    prominence_peaks_fused_pallas,
    prominence_select_scan_pallas,
)
from apda_fft_tpu_torch.ops import detector_cuda
from apda_fft_tpu_torch.ops import peaks_prominence as tprom
from apda_fft_tpu_torch.ops import peaks_resolution as tres

_SLOT_FIELDS = ("cid", "is_cand", "cmag", "prom", "bins", "std", "n_cand")


def _spectra(b, h, seed, kind="modal"):
    """Half-spectrum magnitudes with a zeroed DC bin, float32 numpy."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "modal":
        x = np.zeros((b, h))
        for w in range(b):
            for _ in range(rng.integers(1, 5)):
                c = rng.uniform(4, h - 4)
                width = rng.uniform(0.8, 6.0)
                amp = rng.uniform(1.0, 40.0)
                x[w] += amp * np.exp(-0.5 * ((bins - c) / width) ** 2)
        x += rng.uniform(0.0, 0.3) * rng.random((b, h))
    elif kind == "noise":
        x = rng.random((b, h)) * 5.0
    elif kind == "flat":
        x = np.full((b, h), 2.5)
    else:  # ties: quantized so rounded-magnitude ties are everywhere
        x = np.round(rng.random((b, h)) * 30.0) / 10.0
    x[:, 0] = 0.0
    return x.astype(np.float32)


def _assert_slots_equal(got, want, case):
    for name, g, w in zip(_SLOT_FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (case, name)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{case} {name}")


def _assert_peaks_equal(got, want):
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.freq.numpy(), np.asarray(want.freq), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(want.mag), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(got.damping.numpy(), np.asarray(want.damping), atol=1e-2)
    np.testing.assert_allclose(got.q_factor.numpy(), np.asarray(want.q_factor), atol=1e-2)
    np.testing.assert_allclose(got.prominence.numpy(), np.asarray(want.prominence),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["modal", "noise", "flat", "ties"])
@pytest.mark.parametrize("h", [128, 512])
def test_plain_select_scan_matches_pallas_interpret(kind, h):
    mags = _spectra(24, h, seed=h + len(kind), kind=kind)
    before = detector_cuda.launches
    got = detector_cuda.prominence_select_scan(torch.from_numpy(mags), 16)
    want = prominence_select_scan_pallas(jnp.asarray(mags), 16, block_windows=8,
                                         interpret=True)
    _assert_slots_equal(got, want, f"{kind} h={h}")
    assert detector_cuda.launches == before  # CPU tensors never launch the kernel


def test_fused_peaks_match_pallas_interpret():
    h, m, k = 256, 12, 4
    mags = _spectra(17, h, seed=9, kind="modal")
    fs = np.float32(500.0)
    got = detector_cuda.prominence_peaks_fused(torch.from_numpy(mags), 500.0, 2 * h, k=k,
                                               max_candidates=m)
    want = prominence_peaks_fused_pallas(jnp.asarray(mags), jnp.float32(fs), 2 * h, k=k,
                                         max_candidates=m, block_windows=8, interpret=True)
    _assert_peaks_equal(got, want)


@pytest.mark.parametrize("m", [6, 24])  # 6: per-candidate walk, 24: slot-wise form
@pytest.mark.parametrize("kind", ["modal", "noise", "ties"])
def test_prominence_peaks_match_jax_argmax(m, kind):
    h = 256
    mags = _spectra(20, h, seed=m + len(kind), kind=kind)
    got = tprom.prominence_peaks(torch.from_numpy(mags), 500.0, 2 * h, k=4, max_candidates=m)
    want = jax.jit(jax.vmap(lambda mg: jprom.prominence_peaks(
        mg, jnp.float32(500.0), 2 * h, k=4, max_candidates=m, selection="argmax"
    )))(jnp.asarray(mags))
    _assert_peaks_equal(got, want)


def test_finalize_forms_agree(monkeypatch):
    """The per-candidate walk and the slot-wise form decide identically."""
    h = 256
    mags = torch.from_numpy(_spectra(32, h, seed=21, kind="noise"))
    slot = tprom.prominence_peaks(mags, 500.0, 2 * h, k=4, max_candidates=24)
    monkeypatch.setattr(tprom, "_UNROLL_MAX", 64)
    walk = tprom.prominence_peaks(mags, 500.0, 2 * h, k=4, max_candidates=24)
    for a, b in zip(slot, walk):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_budget_clamps_to_h_and_empty_batch():
    mags = torch.from_numpy(_spectra(4, 32, seed=11, kind="noise"))
    out = detector_cuda.prominence_select_scan(mags, 256)
    assert out[0].shape == (4, 32)
    empty = detector_cuda.prominence_select_scan(torch.zeros((0, 64)), 8)
    assert empty[0].shape == (0, 8) and empty[5].shape == (0,)


def test_flat_spectrum_has_no_candidates():
    mags = torch.from_numpy(_spectra(6, 128, seed=3, kind="flat"))
    cid, is_cand, cmag, prom, bins, std, n_cand = detector_cuda.prominence_select_scan(mags, 8)
    assert not bool(is_cand.any())
    assert int(n_cand.abs().sum()) == 0
    # Exhausted slots hold bin 0 and its magnitude, like an exhausted argmax.
    assert int(cid.abs().sum()) == 0
    np.testing.assert_array_equal(cmag.numpy(), np.zeros((6, 8), np.float32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 64), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        detector_cuda.prominence_select_scan(x.double(), 8)
    with pytest.raises(ValueError, match=r"\[B, H\]"):
        detector_cuda.prominence_select_scan(x[0], 8)
    with pytest.raises(ValueError, match="contiguous"):
        detector_cuda.prominence_select_scan(torch.zeros((64, 4)).T, 8)
    with pytest.raises(ValueError, match="max_candidates"):
        detector_cuda.prominence_select_scan(x, 0)
    with pytest.raises(TypeError, match="torch.Tensor"):
        detector_cuda.prominence_select_scan(np.zeros((4, 64), np.float32), 8)
    assert detector_cuda.launches == 0


def test_prominence_peaks_rejects_other_selections():
    with pytest.raises(ValueError, match="only 'auto'"):
        tprom.prominence_peaks(torch.zeros((1, 64)), 500.0, 128, selection="topk")


@pytest.mark.parametrize("fs", [500.0, 100.3])
def test_resolution_peaks_match_jax(fs):
    h, n_fft = 512, 1024
    mags = _spectra(16, h, seed=int(fs), kind="modal")
    corr = tres.rigid_half_corrections(fs, n_fft)
    tcorr = None if corr is None else torch.from_numpy(np.tile(corr, (16, 1)))
    got = tres.resolution_peaks(torch.from_numpy(mags), fs, n_fft, k=5, half_corr=tcorr)
    if corr is None:
        want = jax.jit(jax.vmap(lambda m: jres.resolution_peaks(m, jnp.float32(fs), n_fft, k=5)))(
            jnp.asarray(mags))
    else:
        want = jax.jit(jax.vmap(lambda m: jres.resolution_peaks(
            m, jnp.float32(fs), n_fft, k=5, half_corr=jnp.asarray(corr))))(jnp.asarray(mags))
    for f in ("count", "idx", "n_candidates"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.freq.numpy(), np.asarray(want.freq), rtol=1e-6)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(want.mag), rtol=1e-6)


@pytest.mark.parametrize("freq_bins", [25, 50, 75, 125, 1000])
def test_discard_count_matches_jax(freq_bins):
    ds = np.float32(500.0 / 4096)
    freq = np.float32(freq_bins) * ds
    want = int(jres._discard_count(jnp.float32(freq), jnp.float32(ds)))
    got = int(tres._discard_count(torch.tensor([freq]), torch.tensor([ds]))[0])
    assert got == want
