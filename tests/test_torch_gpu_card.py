"""The port's kernels and entry points on the card.

The module imports neither JAX nor the JAX package (``tests/oracle.py`` and
``tests/signals.py`` are plain numpy, loaded by path), so it runs on a
machine with a card and no JAX, without the root ``conftest.py`` (which
imports JAX):

    python -m pytest --noconftest tests/test_torch_gpu_*.py

Every test is marked ``gpu`` and skips without a CUDA device.  Each kernel
- B1 (select+scan), B2/B3 (single-window flexible/rigid), B4 (fused front
end), B5 (pre-selected scans) - is called on a CUDA tensor and held against
the plain twin its wrapper runs on a CPU tensor; each entry point runs on
the card and on the CPU, with decisions equal to each other and to the
float64 oracle.  The field ops and the modal analysis (FDD, whose detector
is B1, and SSI) run on the card against the CPU run and scipy.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from apda_fft_tpu_torch.models import batching, modal, ssi, streaming
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.ops import detector_cuda, fft_cuda, integrate, resample, ringdown, srs
from apda_fft_tpu_torch.ops import latency_cuda as tlat
from apda_fft_tpu_torch.ops.peaks_prominence import prominence_select
from apda_fft_tpu_torch.utils.synthetic import modal_records

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SLOT_FIELDS = ("cid", "is_cand", "cmag", "prom", "bins", "std", "n_cand")
DECISIONS = ("count", "idx", "n_candidates", "n_required")
FS = 500.0
N_LONG = 131072


@pytest.fixture(autouse=True)
def _fresh_dynamic_state():
    tpipe.reset_dynamic_state()
    yield
    tpipe.reset_dynamic_state()


def _load(name: str):
    """A plain-numpy helper of ``tests/`` (``oracle.py``, ``signals.py``)
    loaded by path."""
    spec = importlib.util.spec_from_file_location(f"_gpu_{name}",
                                                  os.path.join(_TESTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these paths on the card")


def _spectra(b, h, seed, kind="modal"):
    """Half-spectrum magnitudes with a zeroed DC bin, float32 numpy: modal,
    noise, flat or ties (quantized so rounded-magnitude ties are everywhere)."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "modal":
        x = np.zeros((b, h))
        for w in range(b):
            for _ in range(rng.integers(1, 5)):
                c = rng.uniform(4, h - 4)
                x[w] += rng.uniform(1.0, 40.0) * np.exp(
                    -0.5 * ((bins - c) / rng.uniform(0.8, 6.0)) ** 2)
        x += rng.uniform(0.0, 0.3) * rng.random((b, h))
    elif kind == "noise":
        x = rng.random((b, h)) * 5.0
    elif kind == "flat":
        x = np.full((b, h), 2.5)
    else:
        x = np.round(rng.random((b, h)) * 30.0) / 10.0
    x[:, 0] = 0.0
    return x.astype(np.float32)


def _window(n, fs, seed, kind="modal"):
    """One window: modal (two tones + noise + offset), noise, flat or impulses."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    if kind == "modal":
        x = (np.sin(2 * np.pi * 0.025 * fs * t) + 0.6 * np.sin(2 * np.pi * 0.095 * fs * t)
             + 0.05 * rng.standard_normal(n) + 3.0)
    elif kind == "noise":
        x = rng.standard_normal(n)
    elif kind == "flat":
        x = np.full(n, 2.5)
    else:
        x = np.zeros(n)
        x[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    return x.astype(np.float32)


def _assert_slots_equal(got, want, case):
    for name, g, w in zip(_SLOT_FIELDS, got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.shape == w.shape, (case, name)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{case} {name}")


@pytest.mark.gpu
def test_select_scan_kernel_matches_plain():
    _need_card()
    for kind in ("modal", "noise", "flat", "ties"):
        for h in (2048, 65536):
            mags = torch.from_numpy(_spectra(64 if h < 4096 else 4, h, seed=5, kind=kind)).cuda()
            for m in (2, 12, 128):
                got = detector_cuda.prominence_select_scan(mags, m)
                want = detector_cuda._prominence_select_scan_plain(mags, m)
                _assert_slots_equal(got, want, f"{kind} H={h} M={m}")


@pytest.mark.gpu
def test_scans_kernel_matches_plain():
    _need_card()
    for kind in ("modal", "noise", "flat", "ties"):
        mags = torch.from_numpy(_spectra(64, 2048, seed=5, kind=kind)).cuda()
        for m in (2, 12, 128):
            cid, is_cand, cmag, _, _, _ = prominence_select(mags, m)
            n_valid = is_cand.sum(-1).to(torch.int32)
            got = detector_cuda.prominence_scans(mags, cid, cmag, n_valid)
            want = detector_cuda._prominence_scans_plain(mags, cid, cmag, n_valid)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.gpu
def test_latency_kernels_match_plain_and_the_oracle():
    _need_card()
    oracle = _load("oracle")
    fs = torch.tensor(500.0, device="cuda")
    for kind in ("modal", "noise", "impulse", "flat"):
        xn = _window(4096, 500.0, seed=5, kind=kind)
        x = torch.from_numpy(xn).cuda()
        for mode, budget in (("rigid", 2), ("flexible", 2), ("flexible", 64)):
            got = tlat.analyze_window_lowlat(x, fs, mode=mode, max_candidates=budget,
                                             refine=True)
            want = tlat._analyze_window_lowlat_plain(x, fs, n_fft=4096, mode=mode, k=got.k,
                                                     budget=budget, refine=True)
            for f in ("count", "idx", "n_candidates", "n_required"):
                np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                              getattr(want, f).cpu().numpy(), err_msg=f)
            for f, atol in (("freq", 1e-4), ("mag", 1e-4), ("damping", 1e-2),
                            ("q_factor", 1e-2), ("refined_freq", 1e-3)):
                np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                           getattr(want, f).cpu().numpy(), atol=atol,
                                           rtol=1e-5, err_msg=f)
            if mode == "rigid" or int(got.n_required[0]) <= budget:
                ref = oracle.oracle_analyze(xn.astype(np.float64), 500.0, mode)
                c = int(got.count[0])
                assert got.idx[0, :c].tolist() == [p["idx"] for p in ref], (kind, mode)


@pytest.mark.gpu
def test_front_end_kernel_matches_plain_and_float64():
    _need_card()
    signals = _load("signals")
    for n in (64, 1024, 4096, 65536):
        rng = np.random.default_rng(n)
        xn = np.stack([signals.modal_signal(n, 500.0, seed=n + i) for i in range(2)]
                      + [rng.standard_normal(n)])
        xn = (xn - xn.mean(axis=-1, keepdims=True)).astype(np.float32)
        x = torch.from_numpy(xn).cuda()
        got = fft_cuda.halfspec_magnitudes_fused(x).cpu().numpy()
        want = fft_cuda._halfspec_magnitudes_fused_plain(x).cpu().numpy()
        scale = want.max(axis=-1, keepdims=True)
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-6, rtol=0)
        assert not got[:, 0].any()
        ref = np.abs(np.fft.rfft(xn.astype(np.float64))[:, : n // 2])
        ref[:, 0] = 0.0
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6


# -- entry points ------------------------------------------------------------


def _long_epoch() -> np.ndarray:
    """Two N = 131072 windows: four lightly damped modes (accepted by the
    prominence detector), and two undamped tones on exact bins (rejected by
    its damping floor, so adaptive mode falls back to the resolution
    detector)."""
    signals = _load("signals")
    rng = np.random.default_rng(5)
    modes = [(f * rng.uniform(0.96, 1.04), rng.uniform(1.0, 2.0), rng.uniform(0.002, 0.004))
             for f in (10.0, 18.0, 30.0, 45.0)]
    t = np.arange(N_LONG) / FS
    tones = (np.sin(2 * np.pi * (3000 * FS / N_LONG) * t + 0.3)
             + 0.6 * np.sin(2 * np.pi * (11000 * FS / N_LONG) * t + 1.1)
             + 0.05 * rng.standard_normal(N_LONG) + 0.1)
    return np.stack([signals.modal_signal(N_LONG, FS, modes=modes, noise=0.01, seed=5),
                     tones]).astype(np.float32)


@pytest.mark.gpu
def test_epoch_at_n_131072_on_the_card():
    _need_card()
    oracle = _load("oracle")
    x = _long_epoch()
    for mode in ("flexible", "adaptive"):
        before = detector_cuda.launches
        gpu = tpipe.analyze_epoch(torch.from_numpy(x).cuda(), FS, mode=mode, refine=True,
                                  lowlat="never")
        assert detector_cuda.launches > before
        budget = tpipe.last_dynamic_stats()["candidate_budget"]
        cpu = tpipe.analyze_epoch(torch.from_numpy(x), FS, mode=mode, refine=True,
                                  lowlat="never", max_candidates=budget)
        for f in DECISIONS:
            np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                          getattr(cpu, f).numpy(), err_msg=f"{mode} {f}")
        for i in range(2):
            ref = oracle.oracle_analyze(x[i].astype(np.float64), FS, mode)
            c = int(gpu.count[i])
            assert gpu.idx[i, :c].tolist() == [p["idx"] for p in ref], (mode, i)


def _records():
    """Ragged records in three buckets, one of them at a non-dyadic rate."""
    signals = _load("signals")
    spec = [(3000, 500.0), (4096, 500.0), (2500, 500.0), (7000, 1000.0), (8192, 1000.0),
            (2048, 99.7)]
    return [(signals.modal_signal(n, fs, seed=i).astype(np.float32), fs)
            for i, (n, fs) in enumerate(spec)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flexible", "rigid", "adaptive"])
def test_records_and_welch_on_the_card(mode):
    """``analyze_records`` and ``analyze_welch`` on the card equal the CPU
    run, record by record, and the records' decisions the float64 oracle."""
    _need_card()
    oracle = _load("oracle")
    recs = _records()
    gpu = batching.analyze_records(recs, mode=mode, refine=True)
    cpu = batching.analyze_records(recs, mode=mode, refine=True, device="cpu")
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        assert (g.n_fft, g.row, g.count) == (c.n_fft, c.row, c.count), i
        assert [g.peak(s)["idx"] for s in range(g.count)] == \
            [c.peak(s)["idx"] for s in range(c.count)], i
        assert all(t.device.type == "cpu" for t in g.result)
        samples, fs = recs[i]
        ref = oracle.oracle_analyze(samples.astype(np.float64), fs, mode)
        assert [g.peak(s)["idx"] for s in range(g.count)] == [p["idx"] for p in ref], i

    rng = np.random.default_rng(9)
    t = np.arange(16384) / FS
    x = (rng.standard_normal((4, 16384)) + 0.3 * np.sin(2 * np.pi * 61.0352 * t)).astype(
        np.float32)
    for backend in ("matmul", "pallas"):
        gpu = streaming.analyze_welch(x, FS, window=1024, mode=mode, refine=True,
                                      backend=backend)
        cpu = streaming.analyze_welch(x, FS, window=1024, mode=mode, refine=True,
                                      backend=backend, device="cpu")
        assert gpu.count.device.type == "cuda"
        for f in DECISIONS:
            np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                          getattr(cpu, f).numpy(), err_msg=f"{backend} {f}")


# -- field ops and modal analysis --------------------------------------------


@pytest.mark.gpu
def test_field_ops_on_the_card_match_the_cpu_and_scipy():
    """Integration, severity, ring-down, resampling and the SRS on the card
    against the CPU run (integration within 1e-5 of each row's scale,
    severity rtol 1e-5, ring-down rtol 1e-4 with the same NaNs, SRS rtol
    5e-5) and resampling against ``scipy.signal.resample_poly`` (< 3e-6 of
    the peak: the convolution runs in IEEE float32, not TF32)."""
    _need_card()
    import scipy.signal as sig

    rng = np.random.default_rng(19)
    t = np.arange(4096) / FS
    x = (np.sin(2 * np.pi * 25.3 * t) + 0.2 * rng.standard_normal((8, 4096)) + 0.3).astype(
        np.float32)
    # Rows whose velocity is small beside a 1 g offset and broadband noise:
    # there an imaginary Nyquist bin handed to cuFFT's C2R showed.
    x[4:] = (1.0 + 0.01 * np.sin(2 * np.pi * 180.0 * t)
             + 0.01 * rng.standard_normal((4, 4096))).astype(np.float32)
    for order in (1, 2):
        gpu = integrate.integrate_acceleration(x, FS, order=order)
        cpu = integrate.integrate_acceleration(x, FS, order=order, device="cpu")
        assert gpu.device.type == "cuda"
        scale = cpu.abs().amax(dim=-1)
        assert bool(((gpu.cpu() - cpu).abs().amax(dim=-1) <= 1e-5 * scale).all()), order
    np.testing.assert_allclose(integrate.velocity_rms(x, FS, band=(10.0, 200.0)).cpu().numpy(),
                               integrate.velocity_rms(x, FS, band=(10.0, 200.0),
                                                      device="cpu").numpy(), rtol=1e-5)
    w0 = 2 * np.pi * np.array([20.0, 80.0])[:, None]
    decay = (np.exp(-np.array([[0.01], [0.03]]) * w0 * t[:2048]) * np.sin(w0 * t[:2048])).astype(
        np.float32)
    gpu = ringdown.ringdown_damping(decay, FS, np.array([20.0, 80.0])).cpu().numpy()
    cpu = ringdown.ringdown_damping(decay, FS, np.array([20.0, 80.0]), device="cpu").numpy()
    np.testing.assert_array_equal(np.isnan(gpu), np.isnan(cpu))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4)
    np.testing.assert_allclose(gpu, [0.01, 0.03], rtol=0.1)
    xd = rng.standard_normal((4, 8192))
    for up, down in ((1, 2), (1, 8), (5, 8)):
        got = (resample.decimate(xd, down) if up == 1 else resample.resample_rational(xd, up, down))
        taps = (resample.design_decimation_taps(down) if up == 1
                else resample._rational_taps(up, down, 12, 0.8) / up)
        ref = sig.resample_poly(xd, up, down, axis=-1, window=taps)
        assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-6, (up, down)
    shock = np.where(np.arange(4096) < 11, 50 * np.sin(np.pi * np.arange(4096) / 11), 0.0)
    shock = (shock + 0.5 * rng.standard_normal((4, 4096))).astype(np.float32)
    gpu = srs.shock_response_spectrum(shock, 1000.0)
    cpu = srs.shock_response_spectrum(shock, 1000.0, device="cpu")
    for f in ("maximax", "positive", "negative"):
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f), rtol=5e-5,
                                   atol=1e-6 * np.abs(cpu.maximax).max(), err_msg=f)


def _modal_array(s: int) -> tuple[np.ndarray, np.ndarray]:
    """An ``[s, 16384]`` array at 500 Hz: modes at 12.3, 31.7 and 58.9 Hz
    with bending-like shapes along a line of sensors."""
    shapes = np.array([np.sin(np.pi * (m + 1) * (np.arange(s) + 1) / (s + 1)) for m in range(3)])
    x = modal_records(shapes * np.array([1.0, 2.0, 4.0])[:, None], (12.3, 31.7, 58.9),
                      (0.01, 0.015, 0.02), FS, 16384 / FS, seed=9)
    return x, shapes


@pytest.mark.gpu
def test_fdd_and_ssi_on_the_card_match_the_cpu():
    """``fdd`` (the gateway's call) on the card: B1 launches, every B1 call
    equals its plain twin, decisions equal the CPU run, shapes at MAC >=
    0.99 against the known ones; ``ssi`` on the card: the CPU run's modes."""
    _need_card()
    x, shapes = _modal_array(8)
    calls = []
    real = detector_cuda.prominence_select_scan

    def tap(mags, m):
        out = real(mags, m)
        calls.append((mags.clone(), m, out))
        return out

    before = detector_cuda.launches
    detector_cuda.prominence_select_scan = tap
    try:
        gpu = modal.fdd(x, FS, 1024, efdd=True, harmonics=True)
    finally:
        detector_cuda.prominence_select_scan = real
    assert detector_cuda.launches == before + 1 and len(calls) == 1
    mags, m, got = calls[0]
    _assert_slots_equal(got, detector_cuda._prominence_select_scan_plain(mags, m), "fdd B1")
    cpu = modal.fdd(x, FS, 1024, efdd=True, harmonics=True, device="cpu")
    for f in ("count", "idx", "freq", "damping"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    assert np.abs(gpu.sv1 - cpu.sv1).max() <= 5e-6 * cpu.sv1.max()
    n = int(gpu.count)
    assert n == 3
    assert modal.modal_assurance(gpu.shapes()[:n], shapes).diagonal().min() >= 0.99
    s_gpu, s_cpu = ssi.ssi(x, FS), ssi.ssi(x, FS, device="cpu")
    assert s_gpu.count == s_cpu.count == 3
    for a, b in zip(s_gpu.modes, s_cpu.modes):
        assert abs(a.freq - b.freq) <= 2e-5 * b.freq + b.freq_std
        assert modal.modal_assurance(a.shape, b.shape)[0, 0] >= 0.9999


@pytest.mark.gpu
def test_gateway_on_the_card_matches_the_cpu(tmp_path):
    """The full-feature gateway (``tests/test_torch_gateway_parity.py``'s
    ``FULL_FEATURE``) over 8 sensors and 2 epochs of its traffic mix, on
    the card and on the CPU: the same decisions (history, ``fft_results``,
    uploads, API payloads, drift and modal state), and B1 launched."""
    _need_card()
    gp = _load("test_torch_gateway_parity")
    port = "apda_fft_tpu_torch"
    macs = [f"0013a20041e7{i:04x}" for i in range(8)]
    rng = np.random.default_rng(0)
    epochs = [(gp.full_feature_epoch(port, macs, e, rng), gp.heartbeats(port, macs))
              for e in range(2)]
    surfaces = []
    for device in ("cuda", "cpu"):
        side = gp.Side(port, tmp_path / device, flush_mode="on_sync",
                       gateway_extra=gp.FULL_FEATURE, device=device)
        before = detector_cuda.launches
        for traffic, beat in epochs:
            side.feed(traffic)
            side.feed(beat)
        if device == "cuda":
            assert detector_cuda.launches > before
        surfaces.append(side.surface())
        side.svc.stop()
    gp.assert_same_surface(surfaces[0], surfaces[1], "card vs CPU")
    assert any("[FDD]" in line for line in surfaces[0]["history"])


def _card_mesh(axes=("data",), shape=None):
    """Four shards: the visible cards when there are four, else four logical
    shards of the first card."""
    from apda_fft_tpu_torch.parallel import mesh as tmesh

    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = cards[:4] if len(cards) >= 4 else ["cuda:0"] * 4
    return tmesh.make_mesh(4, axes, shape=shape, devices=devices)


@pytest.mark.gpu
def test_sharded_epoch_on_the_card_matches_one_device():
    """``analyze_epoch_sharded`` on a 4-shard mesh of the card: B1 launches
    on every shard, and decisions, fields (``ROADMAP.md``'s "held against
    the reference" rule) and ``last_dynamic_stats()`` equal the
    single-device epoch's; noisy epochs learn, then run, the two-tier split."""
    _need_card()
    from apda_fft_tpu_torch.parallel import mesh as tmesh

    mesh = _card_mesh()
    t = np.arange(2048) / FS
    epochs = []
    for seed in (11, 12):  # tests/test_torch_parallel.py's two-tier corpus
        rng = np.random.default_rng(seed)
        x = 2.0 * rng.standard_normal((256, 2048))
        for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008), (88.4, 0.55, 0.015)):
            phase = rng.uniform(0, 2 * np.pi, size=(256, 1))
            x += a * np.sin(2 * np.pi * f * t + phase) * np.exp(-zeta * 2 * np.pi * f * t)
        epochs.append(x.astype(np.float32))
    runs = {}
    for side in ("mesh", "single"):
        tpipe.reset_dynamic_state()
        runs[side] = []
        for x in epochs:
            before = detector_cuda.launches
            if side == "mesh":
                res = tmesh.analyze_epoch_sharded(x, FS, mesh=mesh, refine=True)
                assert detector_cuda.launches - before >= 4
                assert res.count.device == torch.device("cuda:0")
            else:
                res = tpipe.analyze_epoch(x, FS, refine=True, batch_chunk=0, lowlat="never")
            runs[side].append((res, dict(tpipe.last_dynamic_stats())))
    assert runs["mesh"][1][1]["tier"] is not None, runs["mesh"][1][1]
    for (one, s_mesh), (want, s_single) in zip(runs["mesh"], runs["single"]):
        assert s_mesh == s_single, (s_mesh, s_single)
        for name in DECISIONS:
            np.testing.assert_array_equal(getattr(one, name).cpu().numpy(),
                                          getattr(want, name).cpu().numpy(), err_msg=name)
        for name, step in (("freq", 1e-4), ("mag", 1e-4), ("damping", 1e-2),
                           ("q_factor", 1e-2), ("prominence", 0.0), ("refined_freq", 0.0)):
            np.testing.assert_allclose(getattr(one, name).cpu().numpy(),
                                       getattr(want, name).cpu().numpy(), rtol=1e-5,
                                       atol=1.01 * step or 1e-6, err_msg=name)


@pytest.mark.gpu
def test_distributed_fft_on_the_card_matches_float64():
    """The sequence-parallel FFT on a (2, 2) mesh of the card: <= 1e-6
    normwise against float64 numpy.fft at N=4096 and N=65536."""
    _need_card()
    from apda_fft_tpu_torch.ops.fft import center_and_pad
    from apda_fft_tpu_torch.parallel.distributed_fft import distributed_halfspec_magnitudes

    mesh = _card_mesh(("data", "seq"), (2, 2))
    for n, b in ((4096, 64), (65536, 4)):
        x = np.stack([_window(n, FS, seed=s) for s in range(b)]).astype(np.float32)
        w = center_and_pad(torch.from_numpy(x).cuda(), n)
        got = distributed_halfspec_magnitudes(w, mesh).cpu().numpy()
        ref = np.abs(np.fft.fft(w.cpu().numpy().astype(np.float64), axis=-1))[:, : n // 2]
        ref[:, 0] = 0.0
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6, n


@pytest.mark.gpu
def test_doctor_passes_on_the_card(capsys):
    _need_card()
    import json

    from apda_fft_tpu_torch.__main__ import main

    assert main(["doctor", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["ok"] is True and all(c["ok"] for c in rep["checks"])


@pytest.mark.gpu
def test_card_results_gathered_on_cpu_shards_match():
    """Copies from the card to CPU shards finish before the host reads
    them: the power iteration on a mesh of the card gives the same bits
    gathered on the CPU as on the card, and ``fdd`` so gathered decides as
    the CPU run does; ``correlation_blocks_sharded``,
    ``analyze_epoch_sharded`` and ``distributed_halfspec_magnitudes`` on a
    CPU mesh give the same bits for a tensor on the card as for its CPU
    copy."""
    _need_card()
    from apda_fft_tpu_torch.parallel import mesh as tmesh
    from apda_fft_tpu_torch.parallel.distributed_fft import distributed_halfspec_magnitudes

    x, _ = _modal_array(8)
    card = _card_mesh()
    _, gr, gi = modal.csd_matrix(x, FS, 1024, device="cpu")
    on_cpu = modal._sv_spectra_sharded(gr, gi, card, "data", modal._POWER_ITERS)
    on_card = modal._sv_spectra_sharded(gr.cuda(), gi.cuda(), card, "data", modal._POWER_ITERS)
    for a, b in zip(on_cpu, on_card):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b.cpu().numpy())
    got = modal.fdd(x, FS, 1024, mesh=card, device="cpu")
    want = modal.fdd(x, FS, 1024, device="cpu")
    for f in ("count", "idx", "freq"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    # test_fdd_and_ssi_on_the_card_match_the_cpu's card-against-CPU bound.
    assert np.abs(got.sv1 - want.sv1).max() <= 5e-6 * want.sv1.max()

    xc = torch.from_numpy(x.astype(np.float32))
    seq = tmesh.make_mesh(4, ("seq",), devices=["cpu"] * 4)
    np.testing.assert_array_equal(tmesh.correlation_blocks_sharded(xc.cuda(), 40, seq),
                                  tmesh.correlation_blocks_sharded(xc, 40, seq))

    data = tmesh.make_mesh(4, devices=["cpu"] * 4)
    w = xc.reshape(-1, 4096)  # 32 windows of 4096 samples
    got = tmesh.analyze_epoch_sharded(w.cuda(), FS, mesh=data, max_candidates=16)
    want = tmesh.analyze_epoch_sharded(w, FS, mesh=data, max_candidates=16)
    for name, a, b in zip(got._fields, got, want):
        assert a.device.type == "cpu", name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)

    grid = tmesh.make_mesh(4, ("data", "seq"), (2, 2), devices=["cpu"] * 4)
    np.testing.assert_array_equal(distributed_halfspec_magnitudes(w.cuda(), grid).numpy(),
                                  distributed_halfspec_magnitudes(w, grid).numpy())
