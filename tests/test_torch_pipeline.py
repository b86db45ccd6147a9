"""The port's epoch pipeline against the JAX package's, on the CPU.

Both packages get the same float32 windows, made from a seed with numpy (the
root conftest turns on JAX's x64, so float32 is passed explicitly).  The JAX
side runs with ``lowlat="never"``, the configuration the port covers.
Decisions (``count``, ``idx``, ``n_candidates``, ``n_required``) and the
dynamic-budget statistics must be equal; values are compared to the stated
tolerances (the frameworks sum in different orders).  Every test starts and
ends with both packages' learned budget tables empty.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu_torch.models import pipeline as tpipe
from tests.oracle import oracle_analyze
from tests.signals import modal_signal, two_mode_signal

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


def _run_both(x, fs=FS, **kw):
    """(port result, JAX result) of one epoch; ``kw`` goes to both."""
    want = jpipe.analyze_epoch(jnp.asarray(x, jnp.float32), fs, lowlat="never",
                               dtype=jnp.float32, **kw)
    got = tpipe.analyze_epoch(torch.from_numpy(np.asarray(x, np.float32)), fs,
                              lowlat="never", **kw)
    return got, want


def _assert_epoch_equal(got, want):
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # atol 1e-4 is the 4-dp rounding step; rtol 1e-6 covers values whose
    # float32 ulp is larger than that (a magnitude of 1864 has ulp 1.2e-4).
    for f in ("freq", "mag"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=1e-6, err_msg=f)
    for f in ("damping", "q_factor"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-2, rtol=0, err_msg=f)
    for f in ("prominence", "refined_freq"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def _assert_oracle_decisions(res, x, fs, mode, windows):
    """Decisions of ``windows`` equal the float64 reference oracle's.

    Frequencies within atol 1e-4, rtol 1e-6: float32's 4-dp rounding can
    land one step from float64's where ``freq * 1e4`` is an exact tie.
    """
    for i in windows:
        want = oracle_analyze(np.asarray(x[i], np.float64), fs, mode)
        c = int(res.count[i])
        assert c == len(want), (mode, i, c, want)
        assert res.idx[i, :c].tolist() == [p["idx"] for p in want], (mode, i)
        np.testing.assert_allclose(res.freq[i, :c].numpy(), [p["freq"] for p in want],
                                   atol=1e-4, rtol=1e-6)


def _modal_windows(b, n, seed0=0):
    return np.stack([modal_signal(n, FS, seed=seed0 + s) for s in range(b)]).astype(np.float32)


def _straggler_corpus(seed, b=256, n=1024, n_noise=16):
    """Lightly noisy four-mode windows with ``n_noise`` pure-noise windows
    at the end: the noise windows need more candidate slots than the rest,
    which is what the two-tier split is learned from."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.2 * rng.standard_normal((b, n))
    for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008),
                       (88.4, 0.55, 0.015), (141.2, 0.45, 0.02)):
        phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
        x += a * np.sin(2 * np.pi * f * t[None] + phase) * np.exp(-zeta * 2 * np.pi * f * t[None])
    x[-n_noise:] = rng.standard_normal((n_noise, n))
    return x.astype(np.float32)


def _jax_stats():
    return dict(jpipe.last_dynamic_stats())


def _port_stats():
    return dict(tpipe.last_dynamic_stats())


def test_two_mode_signal():
    x = two_mode_signal(4096, FS)[None].astype(np.float32)
    got, want = _run_both(x, mode="flexible", refine=True)
    _assert_epoch_equal(got, want)
    assert _port_stats() == _jax_stats()
    freqs = sorted(got.freq[0, : int(got.count[0])].tolist())
    assert any(abs(f - 12.3291) < 1e-3 for f in freqs), freqs
    assert any(abs(f - 47.7295) < 1e-3 for f in freqs), freqs
    _assert_oracle_decisions(got, x, FS, "flexible", [0])


@pytest.mark.parametrize("mode,fs", [("flexible", FS), ("rigid", FS), ("rigid", 100.3),
                                     ("adaptive", FS)])
def test_modal_windows(mode, fs):
    x = _modal_windows(12, 1024)
    got, want = _run_both(x, fs, mode=mode, refine=True)
    _assert_epoch_equal(got, want)
    assert got.freq.shape == (12, 5 if mode == "rigid" else 4)
    _assert_oracle_decisions(got, x, fs, mode, range(4))


def test_adaptive_falls_back_per_window():
    """A sharp on-bin tone at a high bin fails the damping band, so the
    prominence pass leaves its window empty and the resolution detector
    fills it."""
    n = 4096
    tone = 5.0 * np.sin(2 * np.pi * (1500 * FS / n) * np.arange(n) / FS)
    x = np.stack([modal_signal(n, FS, seed=s) for s in range(3)] + [tone]).astype(np.float32)
    flex = tpipe.analyze_epoch(torch.from_numpy(x), FS, mode="flexible")
    assert int(flex.count[3]) == 0
    tpipe.reset_dynamic_state()
    got, want = _run_both(x, mode="adaptive", refine=True)
    _assert_epoch_equal(got, want)
    assert int(got.count[3]) > 0
    _assert_oracle_decisions(got, x, FS, "adaptive", range(4))


def test_noisy_corpus_learns_and_runs_two_tier():
    """Epoch 1 learns the split; epoch 2 runs it, stragglers and all."""
    for epoch, seed in enumerate((1, 8)):
        x = _straggler_corpus(seed)
        got, want = _run_both(x, mode="flexible", refine=True)
        _assert_epoch_equal(got, want)
        assert _port_stats() == _jax_stats(), epoch
        state = tpipe.dynamic_state()
        assert state == {"budget": jpipe._dynamic_budget, "hwm": jpipe._dynamic_budget_hwm,
                         "tier": jpipe._dynamic_tier}
    stats = _port_stats()
    m_small = stats["tier"][0]
    assert stats["tier"] is not None and stats["budget_passes"] == 1
    assert int((got.n_required > m_small).sum()) >= 3  # the big pass decided some windows


def test_state_carries_over_from_jax():
    """The port picks up an epoch from the JAX package's learned tables."""
    jpipe.analyze_epoch(jnp.asarray(_straggler_corpus(1)), FS, lowlat="never",
                        dtype=jnp.float32, refine=True)
    assert jpipe._dynamic_tier, "the JAX epoch did not learn a split"
    tpipe.load_dynamic_state(jpipe._dynamic_budget, jpipe._dynamic_budget_hwm,
                             jpipe._dynamic_tier)
    assert tpipe.dynamic_state() == {"budget": jpipe._dynamic_budget,
                                     "hwm": jpipe._dynamic_budget_hwm,
                                     "tier": jpipe._dynamic_tier}
    x = _straggler_corpus(8)
    assert tpipe.steady_state_max_candidates(1024, "flexible", 256) == \
        jpipe.steady_state_max_candidates(1024, "flexible", 256)
    got, want = _run_both(x, mode="flexible", refine=True)
    _assert_epoch_equal(got, want)
    assert _port_stats() == _jax_stats()
    assert _port_stats()["tier"] is not None and _port_stats()["budget_passes"] == 1


@pytest.mark.parametrize("s_cap", [16, 1])  # 1: the straggler capacity overflows
def test_flex_detect_two_tier_matches_jax(s_cap):
    x = _straggler_corpus(8, b=64, n_noise=8)
    xc = x - x.mean(axis=-1, keepdims=True)
    from apda_fft_tpu.ops.fft import halfspec_magnitudes as jmags
    from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes as tmags

    fs = np.full((64,), FS, np.float32)
    mc = (4, 16, s_cap)
    jdetect = jax.jit(functools.partial(jpipe._flex_detect, n_fft=1024, k=4, max_candidates=mc))
    want = jdetect(jmags(jnp.asarray(xc)), jnp.asarray(fs))
    got = tpipe._flex_detect(tmags(torch.from_numpy(xc)), torch.from_numpy(fs), n_fft=1024,
                             k=4, max_candidates=mc)
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.freq.numpy(), np.asarray(want.freq), atol=1e-4, rtol=1e-6)
    flat = tpipe._flex_detect(tmags(torch.from_numpy(xc)), torch.from_numpy(fs), n_fft=1024,
                              k=4, max_candidates=4)
    need = int((flat.n_required > 4).sum())
    if s_cap == 16:  # every straggler re-detected at the big budget
        assert 0 < need <= s_cap
        assert int(got.n_required.max()) <= 16
    else:  # overflow is reported past the big budget
        assert need > s_cap
        assert int(got.n_required.max()) > 16


def test_ragged_lengths_and_median_centering():
    rng = np.random.default_rng(5)
    x = _modal_windows(8, 1000, seed0=20)
    lengths = rng.integers(300, 1001, size=8).astype(np.int32)
    got, want = _run_both(x, mode="flexible", refine=True, lengths=lengths)
    assert got.count.shape == (8,)
    _assert_epoch_equal(got, want)
    got, want = _run_both(x[:, :1000], mode="flexible", n_fft=1024, center="always")
    _assert_epoch_equal(got, want)


def test_taper_chunks_and_leading_shape():
    x = _modal_windows(20, 512, seed0=40).reshape(4, 5, 512)
    got, want = _run_both(x, mode="flexible", refine=True, taper="hann", batch_chunk=8)
    assert got.count.shape == (4, 5) and got.freq.shape == (4, 5, 4)
    _assert_epoch_equal(got, want)


def test_static_budget_and_per_window_fs():
    x = _modal_windows(6, 1024, seed0=60)
    fs = np.array([500.0, 250.0, 500.0, 125.0, 500.0, 250.0])
    got, want = _run_both(x, fs, mode="flexible", max_candidates=3, refine=True)
    _assert_epoch_equal(got, want)


def test_detect_from_mags_matches_jax():
    x = _straggler_corpus(1, b=64, n_noise=8)
    xc = x - x.mean(axis=-1, keepdims=True)
    from apda_fft_tpu.ops.fft import halfspec_magnitudes as jmags
    from apda_fft_tpu_torch.ops.fft import halfspec_magnitudes as tmags

    want = jpipe.detect_from_mags(jmags(jnp.asarray(xc)), FS, n_fft=1024)
    got = tpipe.detect_from_mags(tmags(torch.from_numpy(xc)), FS, n_fft=1024)
    _assert_epoch_equal(got, want)
    assert _port_stats() == _jax_stats()


def test_spectral_pipeline_and_metrics():
    x = _modal_windows(4, 1024, seed0=80)
    pipe = tpipe.SpectralPipeline(tpipe.PipelineConfig(refine=True, device="cpu"))
    res = pipe(x, FS)
    assert res.count.shape == (4,)
    for key in ("process_time", "wall_time", "percentage_cpu", "memrss", "candidate_budget"):
        assert key in pipe.last_metrics, key
    assert tpipe.PipelineConfig.from_gateway_flag(False).mode == "rigid"
    # A mesh runs the epoch sharded (tests/test_torch_parallel.py), with
    # the same result and metrics.
    from apda_fft_tpu_torch.parallel.mesh import make_mesh

    meshed = tpipe.SpectralPipeline(tpipe.PipelineConfig(refine=True),
                                    mesh=make_mesh(2, devices=["cpu"] * 2))
    on_mesh = meshed(x, FS)
    for name in res._fields:
        np.testing.assert_allclose(getattr(on_mesh, name).numpy(), getattr(res, name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert meshed.last_metrics["candidate_budget"] == pipe.last_metrics["candidate_budget"]
    welch = pipe.welch(x, FS, window=256)
    assert welch.count.shape == (4,)
    assert "wall_time" in pipe.last_metrics and "candidate_budget" not in pipe.last_metrics


def test_top_peak_helpers():
    got, want = _run_both(_modal_windows(3, 1024, seed0=90), mode="flexible")
    np.testing.assert_allclose(got.top_peak_freq().numpy(), np.asarray(want.top_peak_freq()),
                               atol=1e-4)
    np.testing.assert_allclose(got.top_peak_mag().numpy(), np.asarray(want.top_peak_mag()),
                               atol=1e-4)
    assert got.k == want.k == 4


def test_empty_epoch():
    for mode in ("flexible", "rigid", "adaptive"):
        res = tpipe.analyze_epoch(np.zeros((0, 256), np.float32), FS, mode=mode, device="cpu")
        assert res.count.shape == (0,)


@pytest.mark.parametrize("kw,match", [
    ({"lowlat": "always"}, "lowlat"),
    ({"selection": "top_k"}, "selection"),
    ({"precision": "fast", "backend": "xla"}, "matmul backend only"),
    ({"mode": "modal"}, "mode"),
    ({"max_candidates": 2.5}, "max_candidates"),
    ({"center": "median"}, "center"),
    ({"taper": "kaiser"}, "taper"),
    ({"backend": "cufft"}, "backend"),
])
def test_analyze_epoch_validates(kw, match):
    with pytest.raises(ValueError, match=match):
        tpipe.analyze_epoch(np.zeros((2, 256), np.float32), FS, device="cpu", **kw)


def test_pallas_backend_runs():
    """``backend="pallas"`` runs the fused front end's plain twin on the CPU
    and decides like the matmul backend."""
    x = _modal_windows(4, 1024, seed0=70)
    got = tpipe.analyze_epoch(x, FS, backend="pallas", max_candidates=8, refine=True,
                              device="cpu")
    want = tpipe.analyze_epoch(x, FS, backend="matmul", max_candidates=8, refine=True,
                               device="cpu")
    _assert_epoch_equal(got, want)
    assert int(got.count.min()) > 0


def test_fast_precision_is_not_ported_yet():
    """``precision="fast"`` is ported now (TF32 products on the card); the
    CPU has no TF32, so on the CPU its epoch is bit-equal to "highest"."""
    x = _modal_windows(4, 1024, seed0=300)
    fast = tpipe.analyze_epoch(x, FS, precision="fast", refine=True, device="cpu")
    best = tpipe.analyze_epoch(x, FS, precision="highest", refine=True, device="cpu")
    for name in best._fields:
        assert torch.equal(getattr(fast, name), getattr(best, name)), name


def test_arrays_run_on_the_card_by_default(monkeypatch):
    """An array or list has no device of its own: without ``device`` it runs
    on CUDA, so without a card the entry points raise instead of carrying
    on silently on the CPU."""
    from apda_fft_tpu_torch.ops import latency_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _modal_windows(2, 1024, seed0=100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.analyze_epoch(x, FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.analyze_epoch(x.tolist(), FS, mode="rigid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.SpectralPipeline()(x, FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.detect_from_mags(np.zeros((2, 64), np.float32), FS, n_fft=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        latency_cuda.analyze_window_lowlat(x[0], FS)


def test_device_cpu_and_cpu_tensors_stay_on_the_cpu():
    x = _modal_windows(3, 1024, seed0=110)
    want = tpipe.analyze_epoch(torch.from_numpy(x), FS, refine=True)
    runs = (
        lambda: tpipe.analyze_epoch(x, FS, refine=True, device="cpu"),
        lambda: tpipe.SpectralPipeline(tpipe.PipelineConfig(refine=True, device="cpu"))(x, FS),
        lambda: tpipe.SpectralPipeline(tpipe.PipelineConfig(refine=True))(torch.from_numpy(x),
                                                                          FS),
    )
    assert all(t.device.type == "cpu" for t in want)
    for run in runs:
        tpipe.reset_dynamic_state()
        got = run()
        for f, a, b in zip(got._fields, got, want):
            assert a.device.type == "cpu", f
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
