"""The port's pre-selected prominence scans against the JAX package's, on the CPU.

On a CPU tensor ``detector_cuda.prominence_scans`` runs its plain torch
twin; it is held here against the JAX package's Pallas kernel
``prominence_scans_pallas`` in interpret mode on the same slots (integers
and floats equal: both evaluate the same masked reductions, which are exact).
``prominence_peaks_batch`` is held against the JAX package's
``prominence_peaks_batch_pallas`` and the port's ``prominence_peaks`` on the
finalized fields.  The CUDA kernel needs the card: ``test_torch_gpu_card.py``
and ``chip_smoke.py`` compare it with the twin there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.ops import fft as jfft
from apda_fft_tpu.ops.detector_pallas import (
    prominence_peaks_batch_pallas,
    prominence_scans_pallas,
)
from apda_fft_tpu_torch.ops import detector_cuda
from apda_fft_tpu_torch.ops import fft as tfft
from apda_fft_tpu_torch.ops import peaks_prominence as tprom
from tests.signals import modal_signal
from tests.test_torch_detector import _assert_peaks_equal, _spectra


def _slots(mags: np.ndarray, m: int):
    """The port's selection on ``mags``: cid, cmag and the valid count."""
    cid, is_cand, cmag, _, _, _ = tprom.prominence_select(torch.from_numpy(mags), m)
    return cid, cmag, is_cand.sum(-1).to(torch.int32)


@pytest.mark.parametrize("kind", ["modal", "noise", "flat", "ties"])
@pytest.mark.parametrize("m", [4, 16])
def test_plain_matches_pallas_interpret(kind, m):
    mags = _spectra(12, 256, seed=m + len(kind), kind=kind)
    cid, cmag, n_valid = _slots(mags, m)
    before = detector_cuda.scan_launches
    prom, bins = detector_cuda.prominence_scans(torch.from_numpy(mags), cid, cmag, n_valid)
    assert detector_cuda.scan_launches == before  # CPU tensors never launch the kernel
    want_p, want_b = prominence_scans_pallas(
        jnp.asarray(mags), jnp.asarray(cid.numpy()), jnp.asarray(cmag.numpy()),
        jnp.asarray(n_valid.numpy()), block_windows=8, interpret=True)
    assert prom.dtype == torch.float32 and bins.dtype == torch.int32
    np.testing.assert_array_equal(prom.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_b))
    past = np.arange(cid.shape[1])[None] >= n_valid.numpy()[:, None]
    assert not prom.numpy()[past].any() and (bins.numpy()[past] == 1).all()


def test_counts_are_honoured_and_clamped():
    """An arbitrary prefix count: slots past it are 0 / 1, slots before it
    equal the unmasked scans; counts past M or below 0 are clamped."""
    mags = _spectra(6, 128, seed=4, kind="noise")
    cid, cmag, _ = _slots(mags, 8)
    n_valid = torch.tensor([0, 3, 8, 12, -2, 5], dtype=torch.int32)
    prom, bins = detector_cuda.prominence_scans(torch.from_numpy(mags), cid, cmag, n_valid)
    full_p, full_b = tprom._prominence_and_width(torch.from_numpy(mags), cid, cmag)
    for row, nv in enumerate(n_valid.clamp(0, 8).tolist()):
        np.testing.assert_array_equal(prom[row, :nv].numpy(), full_p[row, :nv].numpy())
        np.testing.assert_array_equal(bins[row, :nv].numpy(), full_b[row, :nv].numpy())
        assert not prom[row, nv:].any() and (bins[row, nv:] == 1).all()
    want_p, want_b = prominence_scans_pallas(
        jnp.asarray(mags), jnp.asarray(cid.numpy()), jnp.asarray(cmag.numpy()),
        jnp.asarray(n_valid.clamp(0, 8).numpy()), interpret=True)
    np.testing.assert_array_equal(prom.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("n, fs", [(1024, 500.0), (4096, 250.0)])
def test_batch_detector_matches_jax_and_prominence_peaks(n, fs):
    xs = np.stack([modal_signal(n, fs, seed=50 + i) for i in range(6)]).astype(np.float32)
    jmags = jfft.halfspec_magnitudes(jfft.center_and_pad(jnp.asarray(xs), n))
    tmags = tfft.halfspec_magnitudes(tfft.center_and_pad(torch.from_numpy(xs), n))
    fsv = np.full((6,), fs, np.float32)
    got = detector_cuda.prominence_peaks_batch(tmags, torch.from_numpy(fsv), n)
    # JAX's topk selection may fill empty slots with other bins than the
    # port's bin 0, so only the finalized fields are compared.
    want = prominence_peaks_batch_pallas(jmags, jnp.asarray(fsv), n, interpret=True)
    _assert_peaks_equal(got, want)
    ref = tprom.prominence_peaks(tmags, torch.from_numpy(fsv), n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got.count.min()) > 0


def test_batch_detector_matches_vmapped_jax_on_noise():
    h, n = 256, 512
    mags = _spectra(10, h, seed=13, kind="noise")
    from apda_fft_tpu.ops import peaks_prominence as jprom

    got = detector_cuda.prominence_peaks_batch(torch.from_numpy(mags), 500.0, n,
                                               max_candidates=12)
    want = jax.jit(jax.vmap(lambda mg: jprom.prominence_peaks(
        mg, jnp.float32(500.0), n, k=4, max_candidates=12, selection="argmax"
    )))(jnp.asarray(mags))
    _assert_peaks_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mags = torch.zeros((4, 64))
    cid = torch.zeros((4, 8), dtype=torch.int32)
    cmag = torch.zeros((4, 8))
    nv = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"mags must be \[B, H\]"):
        detector_cuda.prominence_scans(mags[0], cid, cmag, nv)
    with pytest.raises(ValueError, match=r"cid and cmag must be \[B, M\]"):
        detector_cuda.prominence_scans(mags, cid[:3], cmag, nv)
    with pytest.raises(ValueError, match=r"cid and cmag must be \[B, M\]"):
        detector_cuda.prominence_scans(mags, cid, cmag[:, :4], nv)
    with pytest.raises(ValueError, match=r"n_valid must be \[B\]"):
        detector_cuda.prominence_scans(mags, cid, cmag, nv[:2])
    with pytest.raises(TypeError, match="torch.Tensor"):
        detector_cuda.prominence_scans(mags, cid.numpy(), cmag, nv)
    prom, bins = detector_cuda.prominence_scans(torch.zeros((0, 64)), cid[:0], cmag[:0], nv[:0])
    assert prom.shape == (0, 8) and bins.shape == (0, 8)
