"""The port's FDD modal analysis against the JAX package and float64 eigh.

``apda_fft_tpu_torch/models/modal.py`` runs the CSD matrix, the power
iteration and the detector (the select+scan kernel's wrapper; on a CPU
tensor its plain twin) in torch, the rest on the host in numpy.  Inputs are
made with numpy from a seed and run through both packages on the CPU.
Tolerances (measured worst case on these corpora in brackets):

* ``fdd`` decisions - ``count``, ``idx``, ``freq``, ``damping`` - equal;
* ``csd_matrix``: within 2e-6 of ``max |G|`` of the JAX package's [3e-7];
* ``sv1``/``sv2``: within 5e-6 of ``max s1`` of the JAX package's [7e-7];
  against float64 ``eigh`` on the CSD the JAX tests' bounds (s1 rtol 5e-4
  and 2e-3 of the maximum, s2 rtol 5e-3, dominant-vector MAC > 0.999);
* mode shapes: MAC >= 0.99999 against the JAX package's [>= 0.99999994],
  ``sv_ratio`` within 1e-6 [6e-8];
* EFDD damping and kurtosis: NaN pattern equal, rtol 1e-5 [4e-7];
* host code (``_efdd_zeta``, ``modal_assurance``, the trackers, the
  synthetic generator): bit-equal results and equal state sequences.
"""

import numpy as np
import pytest
import torch

from apda_fft_tpu.models import modal as jm
from apda_fft_tpu.models import ssi as jssi
from apda_fft_tpu.utils import synthetic as jsyn
from apda_fft_tpu_torch.models import modal as tm
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.models import ssi as tssi
from apda_fft_tpu_torch.ops import detector_cuda
from apda_fft_tpu_torch.utils import synthetic as tsyn
from tests.signals import two_mode_signal

#: The gateway's array: modes at 12.3, 31.7 and 58.9 Hz with bending-like
#: shapes along a line of sensors (the higher modes scaled up so that all
#: three clear the detector's threshold), fs 500, window 1024.
GATEWAY_FREQS, GATEWAY_ZETAS = (12.3, 31.7, 58.9), (0.01, 0.015, 0.02)


def _line_shapes(s: int) -> np.ndarray:
    return np.array([np.sin(np.pi * (m + 1) * (np.arange(s) + 1) / (s + 1)) for m in range(3)])


def _gateway_array(s: int, seed: int = 9) -> np.ndarray:
    shapes = _line_shapes(s) * np.array([1.0, 2.0, 4.0])[:, None]
    return tsyn.modal_records(shapes, GATEWAY_FREQS, GATEWAY_ZETAS, 500.0, 16384 / 500.0,
                              seed=seed)


def _mode_plus_harmonic(fs=200.0, t_sec=80.0, f_mode=9.3, f_harm=25.37, seed=0,
                        harm_shape=(1.0, 0.9)):
    """A structural mode plus a machinery line (``tests/test_modal.py``)."""
    rng = np.random.default_rng(seed)
    x = jsyn.modal_records(np.array([(1.0, 0.6)]), [f_mode], [0.02], fs, t_sec, seed=seed,
                           sensor_noise=0.0)
    t = np.arange(x.shape[-1]) / fs
    x = x / x.std() + 0.8 * np.asarray(harm_shape)[:, None] * np.sin(
        2 * np.pi * f_harm * t + 0.3)[None, :]
    x += 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def _fuzz_case(case: int):
    """One case of ``tests/test_modal.py``'s fuzz corpus, cut to T = 16384
    (weak modes there may stay below the detector's threshold, so the known
    shapes are not held against)."""
    rng = np.random.default_rng(20260817)
    for _ in range(case + 1):
        s = int(rng.integers(2, 7))
        n_modes = int(rng.integers(1, min(s, 3) + 1))
        fs = float(rng.choice([100.0, 125.0, 250.0]))
        freqs = np.sort(rng.uniform(0.08, 0.4, n_modes)) * fs / 2
        while n_modes > 1 and np.min(np.diff(freqs)) < 6 * fs / 512:
            freqs = np.sort(rng.uniform(0.08, 0.4, n_modes)) * fs / 2
        zetas = rng.uniform(0.006, 0.03, n_modes)
        shapes = rng.standard_normal((n_modes, s))
        shapes /= np.linalg.norm(shapes, axis=1, keepdims=True)
    x = jsyn.modal_records(shapes, freqs, zetas, fs, 16384 / fs, seed=case, sensor_noise=0.03)
    return x, fs, dict(window=512, efdd=True, harmonics=True), None


_FUZZ = [_fuzz_case(c) for c in range(5)]
#: name -> (records [S, T], fs, fdd keywords, known shapes or None)
CORPORA = {
    "two modes": (jsyn.modal_records(np.array([[0.38, 0.71, 0.92, 1.0], [0.87, 1.0, 0.28, -0.75]]),
                                     [9.3, 23.8], [0.012, 0.01], 128.0, 120.0, seed=3),
                  128.0, dict(window=1024, efdd=True, harmonics=True),
                  np.array([[0.38, 0.71, 0.92, 1.0], [0.87, 1.0, 0.28, -0.75]])),
    "efdd, window 2048": (jsyn.modal_records(np.array([[0.6, 1.0, 0.8]]), [12.0], [0.015], 128.0,
                                             128.0, seed=7, sensor_noise=0.01),
                          128.0, dict(window=2048, efdd=True), np.array([[0.6, 1.0, 0.8]])),
    "harmonic": (_mode_plus_harmonic(), 200.0, dict(window=1024, harmonics=True), None),
    "one sensor": (two_mode_signal(16384, 500.0, seed=11)[None].astype(np.float32), 500.0,
                   dict(window=2048, efdd=True), None),
    **{f"fuzz {c}": _FUZZ[c] for c in range(4)},
    "hop 256, no taper": (_FUZZ[2][0], _FUZZ[2][1],
                          dict(window=512, hop=256, taper="none", efdd=True), None),
    "median detrend, k 6": (_FUZZ[4][0], _FUZZ[4][1],
                            dict(window=512, detrend="median", k=6, max_candidates=64), None),
    "gateway, 8 sensors": (_gateway_array(8), 500.0, dict(window=1024, efdd=True, harmonics=True),
                           _line_shapes(8)),
}


def test_modal_records_bit_equal():
    for args, kw in (((np.array([[1.0, 0.5]]), [9.3], [0.02], 100.0, 20.0), {}),
                     ((_line_shapes(5), GATEWAY_FREQS, GATEWAY_ZETAS, 500.0, 4.0),
                      dict(seed=4, sensor_noise=0.1))):
        np.testing.assert_array_equal(tsyn.modal_records(*args, **kw),
                                      jsyn.modal_records(*args, **kw))


@pytest.mark.parametrize("window,hop,taper,detrend", [(512, None, "hann", "mean"),
                                                      (256, 100, "none", "mean"),
                                                      (1000, None, "hamming", "median"),
                                                      (512, 512, "blackman", "mean")])
def test_csd_matrix_matches_jax(window, hop, taper, detrend):
    x = np.random.default_rng(window).standard_normal((3, 4096)).astype(np.float32)
    fj, grj, gij = jm.csd_matrix(x, 256.0, window, hop, taper=taper, detrend=detrend)
    ft, grt, git = tm.csd_matrix(x, 256.0, window, hop, taper=taper, detrend=detrend,
                                 device="cpu")
    assert grt.dtype == torch.float32 and grt.shape == np.asarray(grj).shape
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    scale = np.abs(np.asarray(grj)).max()
    assert np.abs(grt.numpy() - np.asarray(grj)).max() <= 2e-6 * scale
    assert np.abs(git.numpy() - np.asarray(gij)).max() <= 2e-6 * scale


def test_csd_matrix_hermitian_dc_zero():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 2048)).astype(np.float32))
    _, gr, gi = tm.csd_matrix(x, 100.0, 256)
    assert gr.device.type == "cpu"
    np.testing.assert_allclose(gr.numpy(), np.swapaxes(gr.numpy(), -1, -2), atol=1e-7)
    np.testing.assert_allclose(gi.numpy(), -np.swapaxes(gi.numpy(), -1, -2), atol=1e-7)
    assert not gr[0].any() and not gi[0].any()


def _psd_matrices(h, s, rank, seed, spread=None):
    """``[h, s, s]`` Hermitian PSD matrices of the given rank; with
    ``spread``, eigenvalues ``spread**j`` (well separated)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((h, s, rank)) + 1j * rng.standard_normal((h, s, rank))
    if spread is None:
        return a @ a.conj().swapaxes(-1, -2)
    q, _ = np.linalg.qr(a)
    lam = spread ** np.arange(rank) * rng.uniform(1.0, 10.0, (h, 1))
    return (q * lam[:, None, :]) @ q.conj().swapaxes(-1, -2)


def _sv(module_sv, g, torch_in=False):
    gr, gi = np.real(g).astype(np.float32), np.imag(g).astype(np.float32)
    if torch_in:
        gr, gi = torch.from_numpy(gr), torch.from_numpy(gi)
    return [np.asarray(t) for t in module_sv(gr, gi)]


def test_sv_spectra_match_numpy_eigh():
    """``tests/test_modal.py``'s eigh check, at its bounds."""
    g = _psd_matrices(64, 5, 3, seed=9)
    s1, s2, vr, vi = _sv(tm.sv_spectra, g, torch_in=True)
    w, v = np.linalg.eigh(g)
    np.testing.assert_allclose(s1, w[:, -1], rtol=5e-4)
    np.testing.assert_allclose(s2, w[:, -2], rtol=5e-3, atol=1e-3 * w[:, -1].max())
    got = vr + 1j * vi
    mac = np.abs(np.sum(got.conj() * v[:, :, -1], axis=-1)) ** 2 / (
        np.sum(np.abs(got) ** 2, axis=-1) * np.sum(np.abs(v[:, :, -1]) ** 2, axis=-1))
    assert mac.min() > 0.999
    j = np.argmax(np.abs(got) ** 2, axis=-1)
    picked = got[np.arange(64), j]
    assert np.abs(np.imag(picked)).max() < 1e-4 and np.real(picked).min() > 0


def test_sv_spectra_rank1_exact():
    rng = np.random.default_rng(10)
    v = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    g = 3.7 * np.outer(v, v.conj())[None] / np.vdot(v, v).real
    s1, s2, _, _ = _sv(tm.sv_spectra, g, torch_in=True)
    np.testing.assert_allclose(s1[0], 3.7, rtol=1e-5)
    assert 0.0 <= s2[0] < 1e-5 * 3.7


@pytest.mark.parametrize("s,rank,spread", [(2, 2, 0.3), (4, 3, 0.5), (8, 4, 0.4)])
def test_sv_spectra_match_jax_on_separated_eigenvalues(s, rank, spread):
    """Where s2/s1 <= 0.5 sixty steps converge far below float32's ulp, so
    the two packages' summation orders do not show."""
    g = _psd_matrices(128, s, rank, seed=s, spread=spread)
    got = _sv(tm.sv_spectra, g, torch_in=True)
    want = _sv(jm.sv_spectra, g)
    for name, a, b in zip(("s1", "s2"), got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * want[0].max(), err_msg=name)
    mac = jm.modal_assurance(got[2] + 1j * got[3], want[2] + 1j * want[3]).diagonal()
    assert mac.min() > 0.99999


def test_power_iteration_keeps_the_start_vector_and_step_count():
    assert tm._POWER_ITERS == jm._POWER_ITERS == 60
    g = _psd_matrices(16, 3, 3, seed=1)
    for iters in (1, 5):
        got = _sv(lambda a, b: tm.sv_spectra(a, b, iters=iters), g, torch_in=True)
        want = _sv(lambda a, b: jm.sv_spectra(a, b, iters=iters), g)
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5)


def _assert_fdd_equal(got, want, case):
    n = int(want.count)
    assert int(got.count) == n, case
    for f in ("idx", "freq", "damping"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{case} {f}")
    for f in ("freq", "damping", "sv_ratio", "shape_re", "shape_im", "freqs", "sv1", "sv2",
              "damping_efdd"):
        assert getattr(got, f).dtype == np.float32, (case, f)
    assert got.count.dtype == np.int32 and got.kurtosis.dtype == np.float64
    np.testing.assert_array_equal(got.freqs, want.freqs)
    top = want.sv1.max()
    assert np.abs(got.sv1 - want.sv1).max() <= 5e-6 * top, case
    assert np.abs(got.sv2 - want.sv2).max() <= 5e-6 * top, case
    np.testing.assert_allclose(got.sv_ratio, want.sv_ratio, atol=1e-6, err_msg=case)
    if n:
        mac = jm.modal_assurance(got.shapes()[:n], want.shapes()[:n]).diagonal()
        assert mac.min() >= 0.99999, (case, mac)
    assert not got.shapes()[n:].any() and not want.shapes()[n:].any()
    for f in ("damping_efdd", "kurtosis"):
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{case} {f}")
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{case} {f}")


@pytest.mark.parametrize("case", list(CORPORA))
def test_fdd_matches_jax(case):
    x, fs, kw, truth = CORPORA[case]
    got = tm.fdd(torch.from_numpy(x), fs, **kw)
    want = jm.fdd(x, fs, **kw)
    _assert_fdd_equal(got, want, case)
    if truth is not None:
        n = int(got.count)
        assert n >= 1, case
        best = tm.modal_assurance(got.shapes()[:n], truth).max(axis=0)
        assert best.min() > 0.95, (case, best)


def test_fdd_gateway_array_recovers_the_known_modes():
    """The gateway's call (``fdd(records, 500, 1024, efdd=True,
    harmonics=True)``) on an 8-sensor array: all three modes within two bins,
    shapes at MAC >= 0.99, kurtosis of stochastic modes (> 2.5)."""
    x = _gateway_array(8)
    res = tm.fdd(x, 500.0, 1024, efdd=True, harmonics=True, device="cpu")
    n = int(res.count)
    assert n == 3
    assert np.abs(res.freq[:n] - np.array(GATEWAY_FREQS)).max() <= 2 * 500.0 / 1024
    mac = tm.modal_assurance(res.shapes()[:n], _line_shapes(8)).diagonal()
    assert mac.min() >= 0.99, mac
    assert np.isfinite(res.damping_efdd[:n]).all() and (res.kurtosis[:n] > 2.5).all()
    assert not res.harmonic_mask().any()


@pytest.mark.parametrize("case", ["two modes", "fuzz 1", "gateway, 8 sensors"])
def test_fdd_matches_float64_eigh(case):
    """``tests/test_modal.py``'s fuzz oracle: the port's s1 against float64
    ``eigh`` on the port's own CSD, shapes at MAC > 0.995."""
    x, fs, kw, _ = CORPORA[case]
    res = tm.fdd(x, fs, device="cpu", **kw)
    _, gr, gi = tm.csd_matrix(x, fs, kw["window"], device="cpu")
    w, v = np.linalg.eigh(gr.numpy().astype(np.float64) + 1j * gi.numpy().astype(np.float64))
    assert np.abs(res.sv1 - w[:, -1]).max() / w[:, -1].max() < 2e-3
    for i in range(int(res.count)):
        ve, vp = v[int(res.idx[i]), :, -1], res.shapes()[i]
        assert abs(np.vdot(vp, ve)) ** 2 / (np.vdot(vp, vp).real * np.vdot(ve, ve).real) > 0.995


def test_fdd_runs_the_detector_once_at_the_static_budget(monkeypatch):
    """The flexible detector runs through the select+scan kernel's wrapper
    once, on ``[1, window/2]`` magnitudes at ``default_max_candidates``."""
    calls = []
    real = detector_cuda.prominence_select_scan

    def tap(mags, m):
        calls.append((tuple(mags.shape), m))
        return real(mags, m)

    monkeypatch.setattr(detector_cuda, "prominence_select_scan", tap)
    x, fs, kw, _ = CORPORA["two modes"]
    tm.fdd(x, fs, 1024, device="cpu")
    assert calls == [((1, 512), tpipe.default_max_candidates(1024))]


def test_efdd_zeta_bit_equal():
    x, fs, kw, _ = CORPORA["efdd, window 2048"]
    res = jm.fdd(x, fs, **kw)
    _, gr, gi = jm.csd_matrix(x, fs, 2048)
    s1, _, vr, vi = (np.asarray(t, np.float64) for t in jm.sv_spectra(gr, gi))
    rng = np.random.default_rng(3)
    peaks = [int(i) for i in res.idx[: int(res.count)]] + list(rng.integers(1, len(s1), 6))
    for i0 in peaks:
        for mac_min in (0.8, 0.5):
            a = tm._efdd_zeta(s1, vr, vi, i0, fs, 2048, mac_min)
            b = jm._efdd_zeta(s1, vr, vi, i0, fs, 2048, mac_min)
            assert a == b or (np.isnan(a) and np.isnan(b)), (i0, a, b)
    narrow = np.zeros(64)
    narrow[10] = 1.0
    assert np.isnan(tm._efdd_zeta(narrow, np.tile([1.0, 0, 0], (64, 1)), np.zeros((64, 3)), 10,
                                  128.0, 128))


@pytest.mark.parametrize("freqs,kw", [([9.3, 25.37, 60.0], {}),
                                      ([0.0, 100.0, 200.0, np.nan, 80.0], {}),
                                      ([25.37], dict(window=512, rel_bandwidth=0.05, min_bins=1))])
def test_harmonic_indicator_matches_jax(freqs, kw):
    x = _mode_plus_harmonic()
    want = jm.harmonic_indicator(x, 200.0, freqs, **kw)
    got = tm.harmonic_indicator(torch.from_numpy(x), 200.0, freqs, **kw)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    one = tm.harmonic_indicator(x[0], 200.0, [25.37], device="cpu")
    np.testing.assert_allclose(one, jm.harmonic_indicator(x[0], 200.0, [25.37]), rtol=1e-5)


def test_fdd_harmonics_flags_the_machinery_line():
    x = _mode_plus_harmonic()
    res = tm.fdd(x, 200.0, window=1024, harmonics=True, device="cpu")
    n = int(res.count)
    freqs, mask = res.freq[:n], res.harmonic_mask()
    assert not mask[int(np.argmin(np.abs(freqs - 9.3)))]
    assert mask[int(np.argmin(np.abs(freqs - 25.37)))]
    assert np.isnan(res.kurtosis[n:]).all()
    off = tm.fdd(x, 200.0, window=1024, device="cpu")
    assert np.isnan(off.kurtosis).all() and np.isnan(off.damping_efdd).all()
    assert not off.harmonic_mask().any()


# -- host code: MAC and the trackers ------------------------------------------


@pytest.mark.parametrize("shape_a,shape_b", [((3, 6), (3, 6)), ((6,), (2, 6)), ((1, 4), (5, 4))])
def test_modal_assurance_bit_equal(shape_a, shape_b):
    rng = np.random.default_rng(12)
    a = rng.standard_normal(shape_a) + 1j * rng.standard_normal(shape_a)
    b = rng.standard_normal(shape_b)
    for x, y in ((a, b), (a, a), (np.zeros(shape_b), b)):
        np.testing.assert_array_equal(tm.modal_assurance(x, y), jm.modal_assurance(x, y))
    with pytest.raises(ValueError, match="sensor counts differ"):
        tm.modal_assurance(a, rng.standard_normal((2, 5)))


def _fdd_result(module, freqs, shapes, dampings):
    """A hand-built ``FDDResult`` of ``module`` (no FFT involved), as in
    ``tests/test_modal.py``."""
    k = len(freqs)
    shapes = np.asarray(shapes, np.complex128).reshape(k, -1)
    norm = np.linalg.norm(shapes, axis=-1, keepdims=True)
    shapes = shapes / np.where(norm > 0, norm, 1.0)
    return module.FDDResult(
        count=np.int32(k), idx=np.arange(1, k + 1, dtype=np.int32),
        freq=np.asarray(freqs, np.float32), damping=np.asarray(dampings, np.float32),
        sv_ratio=np.zeros(k, np.float32), shape_re=np.real(shapes).astype(np.float32),
        shape_im=np.imag(shapes).astype(np.float32), freqs=np.arange(8, dtype=np.float32),
        sv1=np.ones(8, np.float32), sv2=np.zeros(8, np.float32),
        damping_efdd=np.full(k, np.nan, np.float32))


def _ssi_result(module, freqs, shapes, dampings):
    modes = [module.SSIMode(freq=float(f), damping=float(d), shape=np.asarray(s, np.complex128),
                            order=10, n_orders=8, freq_std=0.0, damping_std=0.0, mpc=1.0)
             for f, s, d in zip(freqs, shapes, dampings)]
    return module.SSIResult(modes=modes, diagram=[], orders=np.arange(2, 12, 2),
                            hankel_sv=np.ones(4), n_sensors=len(shapes[0]) if shapes else 4)


def _epochs(kind: str, n_epochs: int, seed: int):
    """(freqs, shapes, dampings) per epoch: three modes that drift in
    frequency, shape and damping, drop out at random, cross, and meet
    spurious peaks."""
    rng = np.random.default_rng(seed)
    base_f = np.array([8.0, 8.5, 21.0])
    base = rng.standard_normal((3, 4)) + 0.1j * rng.standard_normal((3, 4))
    out = []
    for e in range(n_epochs):
        f = base_f + 0.05 * rng.standard_normal(3)
        if kind == "crossing":
            f[:2] = (8.0 + 0.06 * e, 8.5 - 0.06 * e)
        shapes = base + 0.05 * rng.standard_normal(base.shape)
        if kind == "shape drift":
            shapes[0, 2] += 0.25 * e
        damp = 1.0 + 0.1 * rng.standard_normal(3) + (0.08 * e if kind == "damping rise" else 0)
        damp[rng.random(3) < 0.1] = np.nan
        keep = rng.random(3) > 0.2
        fs_, sh_, dp_ = list(f[keep]), list(shapes[keep]), list(damp[keep])
        if rng.random() < 0.3:
            fs_.append(rng.uniform(30, 40))
            sh_.append(rng.standard_normal(4))
            dp_.append(2.0)
        out.append((fs_, sh_, dp_))
    return out


@pytest.mark.parametrize("kind,result,tracker_kw", [
    ("steady", "fdd", {}),
    ("crossing", "fdd", dict(rel_tol=0.06)),
    ("shape drift", "fdd", dict(mac_alert=0.95, mac_min=0.5)),
    ("damping rise", "ssi", {}),
    ("steady", "ssi", dict(max_missed=1, history_cap=16)),
])
def test_modal_tracker_state_sequence_matches_jax(kind, result, tracker_kw):
    """Both packages' trackers fed the same epochs: the same tracks matched
    or born, the same alerts and the same serialized state after every
    epoch, and a port tracker restored from the JAX package's state."""
    make = _fdd_result if result == "fdd" else _ssi_result
    jt, tt = jm.ModalTracker(**tracker_kw), tm.ModalTracker(**tracker_kw)
    for e, (freqs, shapes, damps) in enumerate(_epochs(kind, 40, seed=len(kind))):
        got = tt.update(make(tm if result == "fdd" else tssi, freqs, shapes, damps), t=60.0 * e)
        want = jt.update(make(jm if result == "fdd" else jssi, freqs, shapes, damps), t=60.0 * e)
        assert [t.track_id for t in got] == [t.track_id for t in want], e
        assert [t.track_id for t in tt.shape_alerts()] == [t.track_id for t in jt.shape_alerts()]
        assert ([t.track_id for t in tt.damping_alerts()]
                == [t.track_id for t in jt.damping_alerts()])
        np.testing.assert_equal(tt.to_dict(), jt.to_dict(), err_msg=str(e))
    for a, b in zip(tt.tracks(), jt.tracks()):
        assert len(a) == len(b)
        assert a.sustained_mac() == b.sustained_mac()
        np.testing.assert_equal(a.sustained_damping(), b.sustained_damping())
        np.testing.assert_equal(a.damping_estimate(), b.damping_estimate())
        np.testing.assert_equal(a.damping_estimate(k=4), b.damping_estimate(k=4))
        np.testing.assert_equal(a.damping_windows(), b.damping_windows())
    np.testing.assert_equal(tm.ModalTracker.from_dict(jt.to_dict()).to_dict(), jt.to_dict())


def test_modal_tracker_follows_modes_through_crossing():
    """``tests/test_modal.py``: MAC keeps two crossing modes' identities."""
    a, b = [1.0, 1.0, 1.0, 1.0], [1.0, 0.4, -0.5, -1.0]
    tr = tm.ModalTracker(rel_tol=0.06)
    born = tr.update(_fdd_result(tm, [10.0, 10.8], [a, b], [1.0, 1.0]))
    id_a = next(t.track_id for t in born if abs(t.last_freq - 10.0) < 1e-6)
    tr.update(_fdd_result(tm, [10.5, 10.4], [a, b], [1.0, 1.0]))
    tracks = {t.track_id: t for t in tr.tracks()}
    assert [round(f, 4) for f in tracks[id_a].freqs] == [10.0, 10.5]
    assert min(tracks[id_a].macs) > 0.99


# -- validation and placement ------------------------------------------------


def test_fdd_validation_matches_jax():
    x = np.zeros((2, 600), np.float32)
    cases = [
        (lambda m, **k: m.fdd(x, 100.0, window=512, **k), ValueError),
        (lambda m, **k: m.fdd(np.zeros((2, 2, 512), np.float32), 100.0, window=128, **k),
         ValueError),
        (lambda m, **k: m.fdd(x, 100.0, window=128, hop=0, **k), ValueError),
        (lambda m, **k: m.csd_matrix(x, 100.0, 128, taper="boxcar", **k), ValueError),
        (lambda m, **k: m.csd_matrix(x, 100.0, 128, detrend="linear", **k), ValueError),
        (lambda m, **k: m.harmonic_indicator(x, 100.0, [5.0], window=4, **k), ValueError),
        (lambda m, **k: m.harmonic_indicator(x[:, :100], 100.0, [5.0], **k), ValueError),
        (lambda m, **k: m.harmonic_indicator(x, 100.0, [5.0], rel_bandwidth=0.7, **k),
         ValueError),
    ]
    for call, exc in cases:
        with pytest.raises(exc) as je:
            call(jm)
        with pytest.raises(exc) as te:
            call(tm, device="cpu")
        assert str(te.value) == str(je.value)
    for t, w, hop in ((4096, 1024, None), (4096, 1024, 100), (1000, 1024, None), (3000, 512, 1)):
        assert tm.fdd_segments(t, w, hop) == jm.fdd_segments(t, w, hop)


def test_fdd_leaves_out_the_sharded_run_and_other_selections():
    """The sharded run (``mesh=``) is ported now and decides as the
    single-device run (``tests/test_torch_parallel.py`` holds it against
    the JAX package's); other selections are still left out."""
    from apda_fft_tpu_torch.parallel.mesh import make_mesh

    x = _fuzz_case(0)[0]
    one = tm.fdd(x, 100.0, 512, device="cpu")
    sharded = tm.fdd(x, 100.0, 512, mesh=make_mesh(4, devices=["cpu"] * 4))
    assert sharded.count == one.count
    np.testing.assert_array_equal(sharded.idx, one.idx)
    np.testing.assert_array_equal(sharded.freq, one.freq)
    with pytest.raises(ValueError, match="auto"):
        tm.fdd(x, 100.0, 512, selection="top_k", device="cpu")


def test_modal_entry_points_run_arrays_on_the_card_by_default(monkeypatch):
    """Without ``device`` an array runs on CUDA, so without a card it
    raises; a CPU tensor runs where it lies, and the device results stay
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _gateway_array(3)[:, :4096]
    for call in (lambda a: tm.fdd(a, 500.0, 1024), lambda a: tm.csd_matrix(a, 500.0, 1024),
                 lambda a: tm.harmonic_indicator(a, 500.0, [12.3])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x.tolist())
        call(torch.from_numpy(x))
    freqs, gr, gi = tm.csd_matrix(torch.from_numpy(x), 500.0, 1024)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in (freqs, gr, gi))
    assert all(t.device.type == "cpu" for t in tm.sv_spectra(gr, gi))
    res = tm.fdd(torch.from_numpy(x), 500.0, 1024)
    assert all(isinstance(v, (np.ndarray, np.generic)) for v in res)
