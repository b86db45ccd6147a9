"""The port's field ops against the JAX package and the JAX tests' oracles.

Integration and vibration severity (``ops/integrate.py``), ring-down damping
(``ops/ringdown.py``), decimation and rational resampling
(``ops/resample.py``) and the shock response spectrum (``ops/srs.py``).
Inputs are made with numpy from a seed and run through both packages on the
CPU.  Tolerances:

* host tables (taps, Tukey window, Smallwood coefficients, the SRS grid):
  bit-equal;
* integration: within 1e-5 of the output's scale of the JAX package and of
  the float64 oracle of ``tests/test_integrate.py:148-172``; severity rtol
  1e-5;
* ring-down: ``zeta`` within the JAX tests' relative bounds of the truth
  (0.10-0.25), within 1e-4 relative of the JAX package (the float32 normal
  equations sum in another order; measured <= 3e-6 here), NaN pattern equal;
* decimate / resample: < 3e-6 of the peak against
  ``scipy.signal.resample_poly`` (``tests/test_resample.py:26``) and against
  the JAX package;
* SRS: rtol 5e-5 against the float64 ``scipy.signal.lfilter`` bank
  (``tests/test_srs.py:93``) and against the JAX package.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from apda_fft_tpu.ops import integrate as jint
from apda_fft_tpu.ops import resample as jres
from apda_fft_tpu.ops import ringdown as jring
from apda_fft_tpu.ops import srs as jsrs
from apda_fft_tpu_torch.ops import integrate as tint
from apda_fft_tpu_torch.ops import resample as tres
from apda_fft_tpu_torch.ops import ringdown as tring
from apda_fft_tpu_torch.ops import srs as tsrs

FS = 500.0
N = 4096
MID = slice(N // 4, 3 * N // 4)


def _records(shape, seed):
    """Tones at 25.3 and 61.7 Hz on a DC offset plus noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / FS
    x = (2.0 * np.sin(2 * np.pi * 25.3 * t) + 0.7 * np.sin(2 * np.pi * 61.7 * t + 0.4) + 0.3
         + 0.2 * rng.standard_normal(shape))
    return x.astype(np.float32)


# -- host tables -------------------------------------------------------------


@pytest.mark.parametrize("n,alpha", [(8, 0.3), (1024, 0.3), (4096, 0.5), (4097, 1.0)])
def test_tukey_bit_equal(n, alpha):
    np.testing.assert_array_equal(tint._tukey(n, alpha), jint._tukey(n, alpha))


@pytest.mark.parametrize("q,ntaps,cutoff", [(2, 12, 0.8), (4, 12, 0.8), (8, 12, 0.8),
                                            (3, 6, 0.5), (5, 2, 1.0)])
def test_decimation_taps_bit_equal(q, ntaps, cutoff):
    np.testing.assert_array_equal(tres.design_decimation_taps(q, ntaps, cutoff),
                                  jres.design_decimation_taps(q, ntaps, cutoff))


@pytest.mark.parametrize("up,down", [(5, 8), (2, 3), (3, 2), (4, 1)])
def test_rational_taps_bit_equal(up, down):
    np.testing.assert_array_equal(tres._rational_taps(up, down, 12, 0.8),
                                  jres._rational_taps(up, down, 12, 0.8))


def test_rate_helpers_match():
    pairs = [(250.0, 62.5), (125.0, 125.0), (100.0, 30.0), (62.5, 125.0), (125.0, 0.0),
             (100.0, 62.5), (np.pi * 100, 100.0), (500.0, 100.0), (1000.0, 333.0)]
    for a, b in pairs:
        assert tres.decimation_factor(a, b) == jres.decimation_factor(a, b), (a, b)
        assert tres.rational_factors(a, b) == jres.rational_factors(a, b), (a, b)


@pytest.mark.parametrize("f_min,f_max,ppo,fs,q", [(10.0, 250.0, 6, 1000.0, 10.0),
                                                  (5.0, 250.0, 6, 1000.0, 10.0),
                                                  (1.0, 64.0, 3, 500.0, 25.0),
                                                  (2.0, 50.0, 12, 1000.0, 5.0)])
def test_srs_tables_bit_equal(f_min, f_max, ppo, fs, q):
    f = tsrs.srs_frequencies(f_min, f_max, ppo)
    np.testing.assert_array_equal(f, jsrs.srs_frequencies(f_min, f_max, ppo))
    for a, b in zip(tsrs._sdof_params(f, fs, q), jsrs._sdof_params(f, fs, q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsrs.smallwood_coefficients(f, fs, q), jsrs.smallwood_coefficients(f, fs, q)):
        np.testing.assert_array_equal(a, b)


# -- integration and severity ------------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kw", [{}, dict(edge_taper=0.0, transition=0.0),
                                dict(f_highpass=5.0, transition=0.5, edge_taper=0.1)])
def test_integration_matches_jax(order, kw):
    x = _records((3, N), seed=order)
    want = np.asarray(jint.integrate_acceleration(x, FS, order=order, **kw))
    got = tint.integrate_acceleration(torch.from_numpy(x), FS, order=order, **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_integration_matches_float64_oracle():
    """The JAX test's float64 numpy re-derivation of the same formulation
    (``tests/test_integrate.py:148``), at its bound."""
    a0, f0 = 2.0, 25.3
    x64 = a0 * np.sin(2 * np.pi * f0 * np.arange(N) / FS)
    win = jint._tukey(N, 0.3)
    spec = np.fft.rfft((x64 - x64.mean()) * win)
    freqs = np.fft.rfftfreq(N, 1 / FS)
    w = 2 * np.pi * freqs
    f_hp = 8.0 * FS / N
    ramp = np.clip((freqs - f_hp) / f_hp, 0, 1)
    gate = np.where(freqs < f_hp, 0.0, 0.5 - 0.5 * np.cos(np.pi * ramp))
    oracle = np.fft.irfft(spec * (-1j) * gate / np.where(w > 0, w, 1.0), n=N)
    got = tint.velocity(x64.astype(np.float32), FS, device="cpu").numpy()
    assert np.max(np.abs(got - oracle)) / np.max(np.abs(oracle)) < 1e-5
    # Analytic amplitude of the flat middle: a0 / w.
    amp = np.sqrt(2.0) * np.sqrt(np.mean(np.square(got[MID])))
    assert amp == pytest.approx(a0 / (2 * np.pi * f0), rel=2e-3)


@pytest.mark.parametrize("order,bound", [(1, 1e-5), (2, 5e-5)])
def test_integration_of_a_severity_batch_matches_float64(order, bound):
    """Rows like the gateway's severity batches (three tones in 5..200 Hz,
    a DC offset up to 1 g, noise): both packages within ``bound`` of each
    row's scale from the float64 oracle - for displacement float32 reaches
    ~2e-5 there, the JAX package as much as the port."""
    rng = np.random.default_rng(order)
    t = np.arange(N) / FS
    x = rng.uniform(-1.0, 1.0, (64, 1)) + 0.01 * rng.standard_normal((64, N))
    for _ in range(3):
        x = x + rng.uniform(0.01, 0.5, (64, 1)) * np.sin(
            2 * np.pi * rng.uniform(5.0, 200.0, (64, 1)) * t + rng.uniform(0, 6.3, (64, 1)))
    x = x.astype(np.float32)
    win = jint._tukey(N, 0.3)
    x64 = x.astype(np.float64)
    spec = np.fft.rfft((x64 - x64.mean(-1, keepdims=True)) * win)
    freqs = np.fft.rfftfreq(N, 1 / FS)
    w = 2 * np.pi * freqs
    f_hp = 8.0 * FS / N
    gate = np.where(freqs < f_hp, 0.0, 0.5 - 0.5 * np.cos(np.pi * np.clip((freqs - f_hp) / f_hp,
                                                                          0, 1)))
    oracle = np.fft.irfft(spec * (-1j) ** order * gate / np.where(w > 0, w, 1.0) ** order, n=N)
    scale = np.abs(oracle).max(-1)
    got = tint.integrate_acceleration(x, FS, order=order, device="cpu").numpy()
    want = np.asarray(jint.integrate_acceleration(x, FS, order=order))
    assert np.max(np.abs(got - oracle).max(-1) / scale) < bound
    assert np.max(np.abs(want - oracle).max(-1) / scale) < bound


@pytest.mark.parametrize("n", [4096, 1001])
def test_inverse_transform_gets_real_edge_bins(monkeypatch, n):
    """The spectrum handed to ``irfft`` has real DC and Nyquist bins, the
    only reading numpy and XLA give them: cuFFT's C2R would let an
    imaginary part there (order 1 rotates the Nyquist bin by -i) leak into
    every sample, 3.6e-4 of a row's scale on the H100."""
    seen = []
    real_irfft = torch.fft.irfft

    def irfft(spec, n=None):
        seen.append(spec.clone())
        return real_irfft(spec, n=n)

    monkeypatch.setattr(torch.fft, "irfft", irfft)
    x = _records((2, n), seed=5)
    for order in (1, 2):
        tint.integrate_acceleration(x, FS, order=order, device="cpu")
    for spec in seen:
        assert not spec[..., 0].imag.any()
        if n % 2 == 0:
            assert not spec[..., n // 2].imag.any()


def test_velocity_and_displacement_are_the_orders():
    x = _records((2, 1024), seed=7)
    for fn, order in ((tint.velocity, 1), (tint.displacement, 2)):
        np.testing.assert_array_equal(
            fn(x, FS, device="cpu").numpy(),
            tint.integrate_acceleration(x, FS, order=order, device="cpu").numpy())


@pytest.mark.parametrize("band", [(10.0, 1000.0), (10.0, 200.0), (30.0, 100.0)])
@pytest.mark.parametrize("n", [1000, 4096])
def test_velocity_rms_matches_jax(band, n):
    x = _records((2, 3, n), seed=n)
    want = np.asarray(jint.velocity_rms(x, FS, band=band))
    got = tint.velocity_rms(x, FS, band=band, device="cpu")
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_velocity_rms_analytic():
    a0, f0 = 2.0, 25.0
    x = (a0 * np.sin(2 * np.pi * f0 * np.arange(N) / FS)).astype(np.float32)
    r = float(tint.velocity_rms(x, FS, band=(10.0, 200.0), device="cpu"))
    assert r == pytest.approx(a0 / (2 * np.pi * f0) / np.sqrt(2), rel=2e-3)
    assert tint.G_TO_MMS2 == jint.G_TO_MMS2


def test_float64_records_stay_float64():
    x = _records((2, 512), seed=3).astype(np.float64)
    got = tint.velocity(x, FS, device="cpu")
    want = np.asarray(jint.velocity(x, FS))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


def test_validation_matches_jax():
    bad = [
        lambda m: m.integrate_acceleration(np.zeros(4, np.float32), FS, **kw(m)),
        lambda m: m.integrate_acceleration(np.zeros(64, np.float32), FS, order=3, **kw(m)),
        lambda m: m.integrate_acceleration(np.zeros(64, np.float32), FS, edge_taper=1.5, **kw(m)),
        lambda m: m.integrate_acceleration(np.zeros(64, np.float32), FS, transition=-0.5,
                                           **kw(m)),
        lambda m: m.velocity_rms(np.zeros(64, np.float32), FS, band=(0.0, 10.0), **kw(m)),
        lambda m: m.velocity_rms(np.zeros(4, np.float32), FS, **kw(m)),
    ]

    def kw(m):
        return {"device": "cpu"} if m is tint else {}

    for case in bad:
        with pytest.raises(ValueError) as je:
            case(jint)
        with pytest.raises(ValueError) as te:
            case(tint)
        assert str(te.value) == str(je.value)


# -- ring-down ---------------------------------------------------------------


def _decay(zeta, f0=20.0, fs=500.0, n=2048, noise=0.0, seed=0, f2=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    w0 = 2 * np.pi * f0
    x = np.exp(-zeta * w0 * t) * np.sin(w0 * np.sqrt(1 - zeta**2) * t)
    if f2 is not None:
        x = x + 0.5 * np.exp(-0.05 * 2 * np.pi * f2 * t) * np.sin(2 * np.pi * f2 * t)
    return (x + noise * rng.standard_normal(n)).astype(np.float32)


#: (records, fs, f0, true zeta or None, relative bound to the truth) - the
#: cases of tests/test_ringdown.py, plus a too-short transient (NaN).
RINGDOWN_CASES = {
    "zeta 0.005": (_decay(0.005), 500.0, 20.0, 0.005, 0.10),
    "zeta 0.01": (_decay(0.01), 500.0, 20.0, 0.01, 0.10),
    "zeta 0.02": (_decay(0.02), 500.0, 20.0, 0.02, 0.10),
    "zeta 0.05": (_decay(0.05), 500.0, 20.0, 0.05, 0.10),
    "two modes, 20 Hz": (_decay(0.01, f2=80.0), 500.0, 20.0, 0.01, 0.15),
    "two modes, 80 Hz": (_decay(0.01, f2=80.0), 500.0, 80.0, 0.05, 0.25),
    "noise": (_decay(0.02, noise=0.02), 500.0, 20.0, 0.02, 0.25),
    "near Nyquist": (_decay(0.02, f0=230.0), 500.0, 230.0, 0.02, 0.15),
    "short": (_decay(0.40, n=64), 500.0, 20.0, None, None),
    "batched f0": (np.stack([_decay(0.01, f0=20.0), _decay(0.03, f0=80.0)]), 500.0,
                   np.array([20.0, 80.0]), np.array([0.01, 0.03]), 0.10),
    "batched fs and f0": (np.stack([_decay(0.01, fs=500.0), _decay(0.02, fs=1000.0, n=4000)[:2048]]),
                          np.array([500.0, 1000.0]), np.array([20.0, 20.0]),
                          np.array([0.01, 0.02]), 0.10),
}


@pytest.mark.parametrize("case", list(RINGDOWN_CASES))
def test_ringdown_matches_truth_and_jax(case):
    x, fs, f0, truth, rel = RINGDOWN_CASES[case]
    got = tring.ringdown_damping(torch.from_numpy(x), fs, f0).numpy()
    want = np.asarray(jring.ringdown_damping(x, fs, f0))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if truth is None:
        assert np.isnan(got).all()
    else:
        np.testing.assert_allclose(got, truth, rtol=rel)


# -- decimation and resampling -----------------------------------------------


@pytest.mark.parametrize("q,t", [(2, 4096), (4, 10000), (5, 12345), (3, 1001), (8, 8192)])
def test_decimate_matches_scipy_and_jax(q, t):
    x = np.random.default_rng(q).standard_normal((3, t))
    ref = sig.resample_poly(x, 1, q, axis=-1, window=tres.design_decimation_taps(q))
    got = tres.decimate(x, q, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-6
    want = jres.decimate(x, q)
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-6


@pytest.mark.parametrize("up,down,t", [(5, 8, 10000), (2, 3, 4096), (3, 2, 5000), (4, 1, 2048)])
def test_resample_rational_matches_scipy_and_jax(up, down, t):
    x = np.random.default_rng(up * down).standard_normal((2, t))
    taps = tres._rational_taps(up, down, 12, 0.8)
    ref = sig.resample_poly(x, up, down, axis=-1, window=taps / up)
    got = tres.resample_rational(torch.from_numpy(x), up, down)
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-6
    want = jres.resample_rational(x, up, down)
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-6


def test_resample_identity_shapes_and_validation():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(3000)
    np.testing.assert_array_equal(tres.resample_rational(x, 3, 3), x)
    np.testing.assert_array_equal(tres.decimate(x[None], 1), x[None])
    np.testing.assert_allclose(tres.resample_rational(x, 4, 8, device="cpu"),
                               tres.resample_rational(x, 1, 2, device="cpu"), atol=0)
    lead = rng.standard_normal((2, 3, 1000))
    assert tres.decimate(lead, 4, device="cpu").shape == (2, 3, 250)
    cases = (("decimate", (x, 0), {}), ("decimate", (x[:4], 8), {}),
             ("resample_rational", (x, 0, 2), {}), ("resample_rational", (x[:4], 1, 8), {}),
             ("design_decimation_taps", (2,), dict(ntaps_per_phase=1)),
             ("design_decimation_taps", (2,), dict(cutoff_rel=1.5)))
    for name, args, kw in cases:
        with pytest.raises(ValueError) as je:
            getattr(jres, name)(*args, **kw)
        with pytest.raises(ValueError) as te:
            getattr(tres, name)(*args, **kw)
        assert str(te.value) == str(je.value)


def test_decimate_rejects_aliases():
    """A 225 Hz tone above the new 62.5 Hz Nyquist must not fold onto the
    passband (``tests/test_resample.py:29``)."""
    fs, q, n = 500.0, 4, 50000
    t = np.arange(n) / fs
    y = tres.decimate(np.sin(2 * np.pi * 0.45 * fs * t) + np.sin(2 * np.pi * 20.0 * t + 0.7), q,
                      device="cpu")
    t2 = np.arange(len(y)) / (fs / q)
    assert np.abs(y - np.sin(2 * np.pi * 20.0 * t2 + 0.7))[100:-100].max() < 5e-3


# -- shock response spectrum -------------------------------------------------


def _half_sine(amp=50.0, tau=0.011, fs=1000.0, n=512, noise=0.0, seed=0):
    t = np.arange(n) / fs
    x = np.where(t < tau, amp * np.sin(np.pi * t / tau), 0.0)
    if noise:
        x = x + noise * np.random.default_rng(seed).standard_normal(n)
    return x.astype(np.float32)


def _lfilter_bank(x, fs, freqs, q=10.0, residual=True):
    """Sequential float64 Smallwood bank: ``[F, T']`` responses."""
    b, a = jsrs.smallwood_coefficients(freqs, fs, q)
    xp = np.asarray(x, np.float64)
    if residual:
        xp = np.concatenate([xp, np.zeros(int(np.ceil(fs / freqs.min())))])
    return np.stack([sig.lfilter(b[:, i], a[:, i], xp) for i in range(len(freqs))])


SRS_CASES = {
    "noisy half sine": (_half_sine(noise=0.5), dict(f_min=5.0, f_max=250.0)),
    "half sine": (_half_sine(), dict(f_min=10.0, f_max=200.0)),
    "low bins, short record": (_half_sine(n=64), dict(freqs=np.array([2.0, 2.5198420997897464]))),
    "no residual": (_half_sine(n=64), dict(f_min=2.0, f_max=50.0, residual=False)),
    "default bank, 4096 samples": (_half_sine(n=4096, noise=0.2, seed=3), {}),
    "q 25": (_half_sine(n=300, tau=0.02), dict(f_min=3.0, f_max=300.0, q=25.0,
                                               points_per_octave=12)),
}


@pytest.mark.parametrize("case", list(SRS_CASES))
def test_srs_matches_lfilter_and_jax(case):
    x, kw = SRS_CASES[case]
    got = tsrs.shock_response_spectrum(x, 1000.0, device="cpu", **kw)
    want = jsrs.shock_response_spectrum(x, 1000.0, **kw)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    y = _lfilter_bank(x, 1000.0, got.freqs, q=kw.get("q", 10.0),
                      residual=kw.get("residual", True))
    for field, ref in (("maximax", np.abs(y).max(-1)), ("positive", y.max(-1)),
                       ("negative", y.min(-1))):
        g = getattr(got, field)
        assert g.dtype == np.float32 and g.shape == ref.shape, field
        np.testing.assert_allclose(g, ref, rtol=5e-5, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=field)
        np.testing.assert_allclose(g, getattr(want, field), rtol=5e-5,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=field)
    assert got.peak() == pytest.approx(want.peak(), rel=5e-5)
    np.testing.assert_allclose(got.pseudo_velocity, got.maximax / (2 * np.pi * got.freqs))


def test_srs_batched_rows_equal_independent_runs():
    xs = np.stack([_half_sine(50.0), _half_sine(20.0, tau=0.03)]).reshape(2, 1, 512)
    batch = tsrs.shock_response_spectrum(xs, 1000.0, f_min=5.0, f_max=100.0, device="cpu")
    assert batch.maximax.shape == (2, 1, len(batch.freqs))
    for i in range(2):
        solo = tsrs.shock_response_spectrum(xs[i, 0], 1000.0, f_min=5.0, f_max=100.0,
                                            device="cpu")
        np.testing.assert_allclose(batch.maximax[i, 0], solo.maximax, rtol=1e-6)


def test_srs_rotation_powers_are_the_scan_matrices():
    """The scan's level-k entries ``(E^s cos sK, E^s sin sK)`` are the
    rotation entries at s = 1 and the repeated square of ``M`` after."""
    freqs = tsrs.srs_frequencies(5.0, 250.0)
    e, alpha, beta = tsrs._sdof_params(freqs, 1000.0, 10.0)
    p = tsrs._rotation_powers(freqs, 1000.0, 10.0, 600)
    assert p.shape == (10, 2, len(freqs))  # s = 1 .. 512 < 600
    np.testing.assert_allclose(p[0, 0], alpha, rtol=1e-12)
    np.testing.assert_allclose(p[0, 1], beta, rtol=1e-12)
    m = np.stack([np.stack([alpha, -beta]), np.stack([beta, alpha])]).transpose(2, 0, 1)
    for k in range(1, 10):
        m = m @ m
        np.testing.assert_allclose(p[k, 0], m[:, 0, 0], rtol=1e-9, atol=1e-15)
        np.testing.assert_allclose(p[k, 1], m[:, 1, 0], rtol=1e-9, atol=1e-15)


def test_srs_validation_matches_jax():
    for call in (lambda m, **k: m.shock_response_spectrum(np.zeros(2, np.float32), 1000.0, **k),
                 lambda m, **k: m.shock_response_spectrum(np.zeros(64, np.float32), 1000.0,
                                                          freqs=np.array([600.0]), **k),
                 lambda m, **k: m.srs_frequencies(0.0, 10.0),
                 lambda m, **k: m.srs_frequencies(1.0, 10.0, 0)):
        with pytest.raises(ValueError) as je:
            call(jsrs)
        with pytest.raises(ValueError) as te:
            call(tsrs, device="cpu")
        assert str(te.value) == str(je.value)


# -- placement ---------------------------------------------------------------


def test_field_ops_run_arrays_on_the_card_by_default(monkeypatch):
    """An array has no device of its own: without ``device`` each entry
    point runs it on CUDA, so without a card it raises; a CPU tensor runs
    where it lies and so do the results."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _records((2, 1024), seed=1)
    calls = (lambda a: tint.velocity(a, FS), lambda a: tint.velocity_rms(a, FS),
             lambda a: tring.ringdown_damping(a, FS, 25.3),
             lambda a: tres.decimate(a, 2), lambda a: tres.resample_rational(a, 5, 8),
             lambda a: tsrs.shock_response_spectrum(a, FS))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x.tolist())
        call(torch.from_numpy(x))
    for t in (tint.velocity(torch.from_numpy(x), FS), tint.velocity_rms(torch.from_numpy(x), FS),
              tring.ringdown_damping(torch.from_numpy(x), FS, 25.3)):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
