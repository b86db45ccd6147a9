"""The port's streams, Welch path and cross spectra against the JAX package's.

The same float32 records, made from a seed with numpy, go through both
packages (the port with ``device="cpu"``; the JAX package on the CPU).
Epoch results are held as in ``test_torch_pipeline.py``: decisions equal,
values to the reference's rounding.  Spectra within 2e-6 of the row
maximum of the JAX package's, densities within 1e-5 relative; against
scipy with the JAX package's own tolerances (``test_welch.py``,
``test_cross_spectra.py``).  The Welch decisions are also held against a
float64 Welch model and the float64 oracle on the corpus of
``test_welch_oracle.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu.models import streaming as jstream
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.models import streaming as tstream
from tests.oracle import oracle_analyze, oracle_prominence_peaks, oracle_resolution_peaks
from tests.signals import modal_signal
from tests.test_cross_spectra import _pair
from tests.test_detector_fuzz import _spec_from_mags
from tests.test_pipelined_epochs import _epochs
from tests.test_torch_pipeline import _assert_epoch_equal
from tests.test_welch_oracle import _oracle_welch_mags, _signal

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


def _noisy_tones(c, t, seed, tones=((25.0, 0.5), (61.0352, 0.3)), noise=1.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / FS
    x = noise * rng.standard_normal((c, t))
    for f, a in tones:
        x += a * np.sin(2 * np.pi * f * tt + rng.uniform(0, 2 * np.pi, (c, 1)))
    return x.astype(np.float32)


def _near(got, want, rel=2e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= rel * scale).all(), float((np.abs(got - want) / scale).max())


# -- frame_records -----------------------------------------------------------


@pytest.mark.parametrize("t, window, hop", [
    (20, 8, 8),      # hop == window: the JAX reshape branch (ragged tail trimmed)
    (20, 8, 4),      # W <= 256: stacked slices
    (1044, 8, 4),    # W = 260 > 256, hop divides window: phase decomposition
    (1040, 8, 4),    # W = 259: the same with a padded phase (W % (window//hop) != 0)
    (1046, 12, 4),   # W = 259, three phases, two padded
    (800, 8, 3),     # W = 265, hop does not divide window: gather
])
def test_frame_records_matches_every_jax_branch(t, window, hop):
    rec = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    want = np.asarray(jstream.frame_records(jnp.asarray(rec), window, hop))
    records = torch.from_numpy(rec)
    got = tstream.frame_records(records, window, hop)
    assert got.shape == want.shape == (2, (t - window) // hop + 1, window)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.data_ptr() == records.data_ptr()  # a view, not a copy
    np.testing.assert_array_equal(
        tstream.frame_records(rec[0], window, hop, device="cpu").numpy(), want[0])


def test_frame_records_validation():
    with pytest.raises(ValueError, match="longer than record"):
        tstream.frame_records(torch.arange(10.0), window=16, hop=4)
    with pytest.raises(ValueError, match="hop"):
        tstream.frame_records(torch.arange(10.0), window=4, hop=0)
    with pytest.raises(ValueError, match="window must be >= 1"):
        tstream.frame_records(torch.arange(10.0), window=0, hop=1)


# -- analyze_stream ----------------------------------------------------------


@pytest.mark.parametrize("hop, mode, backend", [
    (None, "flexible", "matmul"),
    (512, "flexible", "matmul"),
    (512, "rigid", "matmul"),
    (256, "adaptive", "pallas"),
])
def test_analyze_stream_matches_jax(hop, mode, backend):
    n = 1024
    records = np.stack([np.concatenate([modal_signal(n, FS, seed=10 * ch + w) for w in range(3)])
                        for ch in range(2)]).astype(np.float32)
    got = tstream.analyze_stream(records, FS, window=n, hop=hop, mode=mode, backend=backend,
                                 refine=True, device="cpu")
    want = jstream.analyze_stream(records, FS, window=n, hop=hop, mode=mode, backend=backend,
                                  refine=True, lowlat="never", dtype=jnp.float32)
    w = (3 * n - n) // (hop or n) + 1
    assert got.count.shape == (2, w)
    _assert_epoch_equal(got, want)
    if hop is None:
        for ch in range(2):
            for i in range(3):
                ref = oracle_analyze(records[ch, i * n:(i + 1) * n].astype(np.float64), FS,
                                     mode)
                c = int(got.count[ch, i])
                assert got.idx[ch, i, :c].tolist() == [p["idx"] for p in ref]


# -- spectrogram and welch_psd -----------------------------------------------


@pytest.mark.parametrize("taper, detrend", [("none", "median"), ("hann", "mean"),
                                            ("blackman", "median")])
def test_spectrogram_matches_jax(taper, detrend):
    x = _noisy_tones(3, 8192, seed=1)
    fs = np.array([500.0, 250.0, 125.0])
    kw = dict(window=1000, hop=700, taper=taper, detrend=detrend)
    f_got, m_got = tstream.spectrogram(x, fs, device="cpu", **kw)
    f_want, m_want = jstream.spectrogram(x, fs, **kw)
    assert m_got.shape == (3, (8192 - 1000) // 700 + 1, 512)
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want), rtol=1e-7)
    _near(m_got.numpy(), m_want)
    f1, _ = tstream.spectrogram(x[0], FS, window=1024, device="cpu")
    assert f1.shape == (512,)
    with pytest.raises(ValueError, match="unknown taper"):
        tstream.spectrogram(x, FS, window=1024, taper="tukey", device="cpu")


@pytest.mark.parametrize("backend", ["matmul", "pallas", "xla"])
def test_welch_psd_matches_jax_and_scipy(backend):
    window = 1024
    noise = np.random.default_rng(7).standard_normal(1 << 15).astype(np.float32)
    freqs, psd = tstream.welch_psd(noise, FS, window=window, backend=backend, device="cpu")
    f_j, p_j = jstream.welch_psd(noise, FS, window=window, backend=backend)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(f_j), rtol=1e-7)
    np.testing.assert_allclose(psd.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-12)
    assert float(psd[0]) == 0.0
    f_sp, p_sp = scipy.signal.welch(noise.astype(np.float64), fs=FS, window=np.hanning(window),
                                    nperseg=window, noverlap=window // 2, detrend="constant")
    h = window // 2
    np.testing.assert_allclose(freqs.numpy(), f_sp[:h], rtol=0, atol=1e-5)
    np.testing.assert_allclose(psd.numpy()[1:h], p_sp[1:h], rtol=2e-2)


def test_welch_psd_multichannel_detrend_and_rect():
    x = _noisy_tones(2, 8192, seed=3)
    for kw in (dict(taper="none"), dict(detrend="median", taper="hamming")):
        f_got, p_got = tstream.welch_psd(x, np.array([250.0, 500.0]), window=512, hop=200,
                                         device="cpu", **kw)
        f_want, p_want = jstream.welch_psd(x, np.array([250.0, 500.0]), window=512, hop=200,
                                           **kw)
        assert p_got.shape == f_got.shape == (2, 256)
        np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want), rtol=1e-7)
    with pytest.raises(ValueError, match="unknown detrend"):
        tstream.welch_psd(x, FS, window=512, detrend="linear", device="cpu")


# -- analyze_welch -----------------------------------------------------------


@pytest.mark.parametrize("mode, detrend, fs", [
    ("flexible", "mean", FS),
    ("flexible", "median", FS),
    ("rigid", "mean", FS),
    ("rigid", "median", 99.7),   # non-dyadic: the host wipe-rounding table
    ("adaptive", "mean", FS),
    ("adaptive", "median", 99.7),
])
def test_analyze_welch_matches_jax(mode, detrend, fs):
    x = _noisy_tones(3, 16384, seed=11)
    kw = dict(window=2048, mode=mode, detrend=detrend, refine=True)
    got = tstream.analyze_welch(x, fs, device="cpu", **kw)
    want = jstream.analyze_welch(x, fs, **kw)
    assert got.count.shape == (3,)
    _assert_epoch_equal(got, want)
    assert int(got.count.min()) > 0
    one = tstream.analyze_welch(x[0], fs, device="cpu", **kw)
    assert one.count.shape == () and one.idx.shape == (5 if mode == "rigid" else 4,)
    _assert_epoch_equal(one, jstream.analyze_welch(x[0], fs, **kw))


def test_analyze_welch_options_and_validation():
    x = _noisy_tones(2, 8192, seed=12)
    for kw in (dict(window=1000, hop=300, taper="hamming", max_candidates=7, k=3),
               dict(window=512, taper="none", backend="pallas")):
        _assert_epoch_equal(tstream.analyze_welch(x, FS, device="cpu", **kw),
                            jstream.analyze_welch(x, FS, **kw))
    for kw, match in ((dict(taper="kaiser"), "unknown taper"), (dict(mode="bogus"), "mode"),
                      (dict(detrend="linear"), "unknown detrend"),
                      (dict(precision="low"), "precision"),
                      (dict(precision="fast", backend="xla"), "matmul backend only"),
                      (dict(selection="topk"), "selection")):
        with pytest.raises(ValueError, match=match):
            tstream.analyze_welch(x, FS, window=1024, device="cpu", **kw)


@pytest.mark.parametrize("seed", range(12))
def test_welch_decisions_match_float64_oracle(seed):
    """The corpus of ``test_welch_oracle.py``: the port's decisions equal the
    float64 Welch model's under the float64 oracle detectors, and the JAX
    package's."""
    rng = np.random.default_rng(8100 + seed)
    for _ in range(5):
        n = int(rng.choice([4096, 8192]))
        window = int(rng.choice([512, 1024]))
        fs = float(rng.choice([31.25, 62.5, 125.0, 250.0, 500.0]))
        mode = ("flexible", "rigid")[int(rng.integers(0, 2))]
        x = _signal(rng, n, fs)
        hop = window // 2
        avg64 = _oracle_welch_mags(x, window, hop)
        oracle = oracle_prominence_peaks if mode == "flexible" else oracle_resolution_peaks
        ref = [p["idx"] for p in oracle(_spec_from_mags(avg64), fs)]
        res = tstream.analyze_welch(x, fs, window=window, hop=hop, mode=mode, device="cpu")
        assert res.idx[: int(res.count)].tolist() == ref, (seed, n, window, fs, mode)
        want = jstream.analyze_welch(x, fs, window=window, hop=hop, mode=mode)
        assert res.idx.tolist() == np.asarray(want.idx).tolist()


# -- cross spectra -----------------------------------------------------------


def test_cross_psd_matches_jax_and_scipy():
    x, y, _ = _pair(T=1 << 15)
    window = 1024
    freqs, pxy = tstream.cross_psd(x, y, FS, window=window, device="cpu")
    f_j, p_j = jstream.cross_psd(x, y, FS, window=window)
    assert isinstance(pxy, np.ndarray) and np.iscomplexobj(pxy) and pxy[0] == 0
    assert pxy.dtype == np.asarray(p_j).dtype
    np.testing.assert_allclose(freqs.numpy(), np.asarray(f_j), rtol=1e-7)
    scale = np.abs(p_j).max()
    np.testing.assert_allclose(pxy, p_j, rtol=1e-5, atol=1e-6 * scale)
    f_sp, p_sp = scipy.signal.csd(x.astype(np.float64), y.astype(np.float64), fs=FS,
                                  window=np.hanning(window), nperseg=window,
                                  noverlap=window // 2, detrend="constant")
    h = window // 2
    np.testing.assert_allclose(freqs.numpy(), f_sp[:h], atol=1e-5)
    b = round(40.0 * window / FS)
    ours, theirs = pxy[1:h], p_sp[1:h]
    assert abs(ours[b - 1]) == pytest.approx(abs(theirs[b - 1]), rel=0.02)
    assert np.angle(ours[b - 1]) == pytest.approx(np.angle(theirs[b - 1]), abs=0.02)
    assert np.angle(ours[b - 1]) == pytest.approx(-np.pi / 4, abs=0.05)
    k = 32
    sm = lambda a: np.convolve(np.abs(a), np.ones(k) / k, mode="valid")  # noqa: E731
    np.testing.assert_allclose(sm(ours), sm(theirs), rtol=0.1)
    with pytest.raises(ValueError, match="shapes differ"):
        tstream.cross_psd(x, y[:-1], FS, window=512, device="cpu")


def test_coherence_matches_jax_and_scipy():
    x, y, _ = _pair(T=1 << 15, seed=1)
    window = 1024
    freqs, cxy = tstream.coherence(x, y, FS, window=window, device="cpu")
    _, c_j = jstream.coherence(x, y, FS, window=window)
    np.testing.assert_allclose(cxy.numpy(), np.asarray(c_j), atol=1e-5)
    _, c_sp = scipy.signal.coherence(x.astype(np.float64), y.astype(np.float64), fs=FS,
                                     window=np.hanning(window), nperseg=window,
                                     noverlap=window // 2, detrend="constant")
    h = window // 2
    np.testing.assert_allclose(cxy.numpy()[1:h], c_sp[1:h], atol=0.02)
    b = round(40.0 * window / FS)
    assert float(cxy[b]) > 0.95 and float(cxy[b + 30:b + 200].mean()) < 0.1


def test_coherence_with_phase_matches_jax():
    x, y, _ = _pair(T=8192, seed=21)
    xs, ys = np.stack([x, y]), np.stack([y, x])
    f, cxy, phase = tstream.coherence_with_phase(xs, ys, FS, 1024, hop=300, taper="blackman",
                                                 detrend="median", device="cpu")
    f_j, c_j, ph_j = jstream.coherence_with_phase(xs, ys, FS, 1024, hop=300, taper="blackman",
                                                  detrend="median")
    assert cxy.shape == phase.shape == (2, 512)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=1e-7)
    np.testing.assert_allclose(cxy.numpy(), np.asarray(c_j), atol=1e-5)
    b = round(40.0 * 1024 / FS)
    np.testing.assert_allclose(phase.numpy()[:, b], np.asarray(ph_j)[:, b], atol=1e-3)
    assert float(phase[0, b]) == pytest.approx(-45.0, abs=5.0)
    assert float(phase[1, b]) == pytest.approx(45.0, abs=5.0)


def test_coherence_zero_channel_is_zero():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    z = np.zeros(4096, np.float32)
    _, cxy, phase = tstream.coherence_with_phase(x, z, FS, 1024, device="cpu")
    _, c_j, _ = jstream.coherence_with_phase(x, z, FS, 1024)
    assert float(cxy.abs().max()) == 0.0 == float(np.abs(np.asarray(c_j)).max())
    assert bool(torch.isfinite(phase).all())


# -- analyze_epochs_pipelined ------------------------------------------------


@pytest.mark.parametrize("mode", ["flexible", "rigid"])
@pytest.mark.parametrize("depth", [1, 4])
def test_pipelined_matches_sequential_and_jax(mode, depth):
    epochs = _epochs()
    got = list(tstream.analyze_epochs_pipelined(epochs, FS, depth=depth, mode=mode,
                                                refine=True, device="cpu"))
    want = list(jstream.analyze_epochs_pipelined(epochs, FS, depth=depth, mode=mode,
                                                 refine=True))
    assert len(got) == len(want) == len(epochs)
    # The sticky tables after the same stream are the JAX package's.
    state = tpipe.dynamic_state()
    assert state["budget"] == jpipe._dynamic_budget
    assert state["hwm"] == jpipe._dynamic_budget_hwm
    if mode == "flexible":
        assert state["hwm"][(1024, "flexible")] > tpipe._DYNAMIC_FLOOR
    for samples, res, jres in zip(epochs, got, want):
        _assert_epoch_equal(res, jres)
        seq = tpipe.analyze_epoch(samples, FS, mode=mode, refine=True, device="cpu")
        for f in res._fields:
            np.testing.assert_array_equal(getattr(res, f).numpy(), getattr(seq, f).numpy(),
                                          err_msg=f)


def test_pipelined_is_lazy_in_order_and_bounded():
    epochs = _epochs()
    pulled = []

    def source():
        for i, e in enumerate(epochs):
            pulled.append(i)
            yield e

    gen = tstream.analyze_epochs_pipelined(source(), FS, depth=2, device="cpu")
    assert pulled == []  # nothing runs before the first next()
    first = next(gen)
    assert first.count.shape == (3,) and pulled == [0, 1, 2]
    assert [r.count.shape for r in gen] == [(2,), (1,), (1,)]

    # Clean epochs (no overflow re-run): every analyze call is a dispatch
    # and every yield retires one, so at most ``depth`` are in flight.
    t = np.arange(1024) / FS
    clean = [(np.sin(2 * np.pi * 0.025 * FS * t) * (1 + 0.1 * s)).astype(np.float32)[None]
             for s in range(5)]
    in_flight = seen_max = 0

    def counting(samples, f, **kw):
        nonlocal in_flight, seen_max
        in_flight += 1
        seen_max = max(seen_max, in_flight)
        return tpipe.analyze_epoch(samples, f, **kw)

    for _ in tstream.analyze_epochs_pipelined(clean, FS, depth=2, analyze=counting,
                                              device="cpu"):
        in_flight -= 1
    assert seen_max == 2


def test_int_budget_dispatch_reads_nothing_back(monkeypatch):
    """What ``analyze_epochs_pipelined`` queues for a flexible epoch - the
    placement, then ``analyze_epoch`` at an int budget, batched or on the
    (faked) single-window route - reads no value back to the host, so on the
    card it does not wait for the card.  (The rigid route's kernel reads
    nothing either; its plain twin here reads its done flags.)"""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read on the dispatch path")

    x = _epochs()[0]
    want = [tpipe.analyze_epoch(s, FS, max_candidates=8, refine=True, device="cpu")
            for s in (x, x[:1])]
    with monkeypatch.context() as m:
        m.setattr(tpipe, "_lowlat_device", lambda samples: True)
        for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
            m.setattr(torch.Tensor, name, refuse)
        got = [tpipe.analyze_epoch(tpipe._placed(s, "cpu", torch.float32), FS,
                                   max_candidates=8, refine=True) for s in (x, x[:1])]
    for g, w in zip(got, want):
        _assert_epoch_equal(g, type(w)(*(t.numpy() for t in w)))


def test_pipelined_validation_errors_raise_eagerly():
    with pytest.raises(ValueError, match="flexible.*rigid"):
        tstream.analyze_epochs_pipelined([], FS, mode="adaptive")
    with pytest.raises(ValueError, match="candidate budget"):
        tstream.analyze_epochs_pipelined([], FS, max_candidates=8)
    with pytest.raises(ValueError, match="depth"):
        tstream.analyze_epochs_pipelined([], FS, depth=0)
    with pytest.raises(ValueError, match="lengths"):
        tstream.analyze_epochs_pipelined([], FS, lengths=np.array([4]))
    assert list(tstream.analyze_epochs_pipelined([], FS)) == []


def test_arrays_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _noisy_tones(2, 4096, seed=5)
    for call in (lambda: tstream.frame_records(x, 1024, 512),
                 lambda: tstream.analyze_stream(x, FS, window=1024),
                 lambda: tstream.analyze_welch(x, FS, window=1024),
                 lambda: tstream.spectrogram(x, FS, window=1024),
                 lambda: tstream.welch_psd(x, FS, window=1024),
                 lambda: tstream.cross_psd(x[0], x[1], FS, window=1024),
                 lambda: tstream.coherence_with_phase(x[0], x[1], FS, window=1024),
                 lambda: next(tstream.analyze_epochs_pipelined([x], FS))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # A CPU tensor runs where it lies.
    res = tstream.analyze_welch(torch.from_numpy(x), FS, window=1024)
    assert res.count.device.type == "cpu"
