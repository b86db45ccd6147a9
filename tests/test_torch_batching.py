"""The port's record batching against the JAX package's, on the CPU.

Ragged ``(samples, fs)`` records go through both packages' ``analyze_records``
and ``analyze_records_welch`` (the port with ``device="cpu"``): every
record's view (bucket, row, count), every ``peak()`` field to the stated
tolerances, and ``exact_freq`` exactly.  Each bucket's result comes to the
host in one copy per dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import batching as jbatch
from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu_torch.models import batching as tbatch
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.models import streaming as tstream
from tests.signals import modal_signal
from tests.test_torch_pipeline import _assert_epoch_equal


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


def _ragged(fs_odd=250.0):
    """Seven records in four buckets (512, 1024 x3, 2048, 4096 x2)."""
    spec = [(1000, 500.0), (4096, 250.0), (900, 500.0), (2000, fs_odd), (300, 500.0),
            (1024, 500.0), (3000, 250.0)]
    return [(modal_signal(n, fs, seed=i).astype(np.float32), fs) for i, (n, fs) in
            enumerate(spec)]


def _noisy_tone(n, fs, tone, amp, seed, noise=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    return (noise * rng.standard_normal(n) + amp * np.sin(2 * np.pi * tone * t)).astype(
        np.float32)


def _assert_views_equal(got, want, mode):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.n_fft, g.row, g.count) == (w.n_fft, w.row, w.count)
        assert g.fs == w.fs
        for s in range(g.count):
            pg, pw = g.peak(s), w.peak(s)
            assert pg["idx"] == pw["idx"]
            for f, atol, rtol in (("freq", 1e-4, 1e-6), ("mag", 1e-4, 1e-6),
                                  ("damping", 1e-2, 0), ("q_factor", 1e-2, 0),
                                  ("prominence", 1e-6, 1e-5), ("refined_freq", 1e-6, 1e-5)):
                assert pg[f] == pytest.approx(pw[f], abs=atol, rel=rtol), f
            assert g.exact_freq(s, mode) == w.exact_freq(s, mode)
        assert all(t.device.type == "cpu" for t in g.result)


@pytest.mark.parametrize("mode, fs_odd", [("flexible", 250.0), ("rigid", 99.7),
                                          ("adaptive", 99.7)])
def test_analyze_records_matches_jax(mode, fs_odd):
    recs = _ragged(fs_odd)
    calls = []
    got = tbatch.analyze_records(recs, mode=mode, refine=True, device="cpu",
                                 on_bucket=lambda n, idxs: calls.append((n, tuple(idxs))))
    want = jbatch.analyze_records(recs, mode=mode, refine=True, lowlat="never",
                                  dtype=jnp.float32)
    assert calls == [(512, (4,)), (1024, (0, 2, 5)), (2048, (3,)), (4096, (1, 6))]
    assert [rp.n_fft for rp in got] == [1024, 4096, 1024, 2048, 512, 1024, 4096]
    _assert_views_equal(got, want, mode)
    assert sum(rp.count for rp in got) > 0


def test_adaptive_exact_freq_recovers_per_window_detector():
    """Flexible-served windows report 4-dp rounded frequencies, windows the
    resolution detector filled the unrounded value."""
    t = np.arange(1024) / 500.0
    rng = np.random.default_rng(3)
    peaky = np.sin(2 * np.pi * 12.3 * t) + 0.05 * rng.standard_normal(1024)
    sharp = np.exp(-2 * np.pi * 30.0 * 0.10 * t) * np.sin(2 * np.pi * 30.0 * t)
    recs = [(peaky.astype(np.float32), 500.0), (sharp.astype(np.float32), 500.0)]
    got = tbatch.analyze_records(recs, mode="adaptive", device="cpu")
    _assert_views_equal(got, jbatch.analyze_records(recs, mode="adaptive", dtype=jnp.float32),
                        "adaptive")
    assert got[0].exact_freq(0, "adaptive") == round(int(got[0].result.idx[0, 0]) * 500.0 / 1024,
                                                     4)
    assert got[1].count > 0 and float(got[1].result.prominence[1, 0]) == 0.0
    assert got[1].exact_freq(0, "adaptive") == int(got[1].result.idx[1, 0]) * (500.0 / 1024)


def test_pow2_pad_is_invisible_and_every_bucket_takes_the_batched_path():
    recs = [(_noisy_tone(1024, 500.0, 61.0352, 2.0, seed=s, noise=0.2), 500.0)
            for s in range(5)]  # B=5 -> padded to 8
    seen = []

    def probe(batch, f, **kw):
        seen.append((batch.shape, kw["lengths"].tolist(), f.tolist()))
        return tpipe.analyze_epoch(batch, f, device="cpu", **kw)

    padded = tbatch.analyze_records(recs, analyze=probe)
    exact = tbatch.analyze_records(recs, batch_pad=None, device="cpu")
    assert seen == [((8, 1024), [1024] * 8, [500.0] * 8)]  # lengths always passed
    for p, e in zip(padded, exact):
        assert p.count == e.count > 0
        assert all(p.peak(s) == e.peak(s) for s in range(p.count))
    # Pad rows replicate the last record.
    res = padded[0].result
    for row in range(5, 8):
        assert torch.equal(res.idx[row], res.idx[4])


def test_host_buffers_keep_a_float64_request():
    x = np.random.default_rng(0).standard_normal(1000)
    seen = []

    def probe(batch, fs, **kw):
        seen.append(batch.dtype)
        return tpipe.analyze_epoch(batch.astype(np.float32), fs, device="cpu", lengths=kw[
            "lengths"], n_fft=kw["n_fft"])

    for dtype in (torch.float64, np.float64, jnp.float64):
        tbatch.analyze_records([(x, 500.0)], analyze=probe, dtype=dtype)
    tbatch.analyze_records([(x, 500.0)], analyze=probe)
    tbatch.analyze_records([(x, 500.0)], analyze=probe, dtype=torch.float32)
    assert seen == [np.float64] * 3 + [np.float32] * 2
    pipe = tpipe.SpectralPipeline(tpipe.PipelineConfig(dtype=torch.float64, device="cpu"))
    probe.config = pipe.config
    tbatch.analyze_records([(x, 500.0)], analyze=probe)
    assert seen[-1] == np.float64

    welch_seen = []

    class Hook:
        config = tpipe.PipelineConfig(dtype=torch.float64)

        def welch(self, batch, fs, **kw):
            welch_seen.append(batch.dtype)
            return tstream.analyze_welch(batch, fs, device="cpu", **kw)

    tbatch.analyze_records_welch([(x, 500.0)], window=256, analyze=Hook().welch)
    tbatch.analyze_records_welch([(x, 500.0)], window=256, device="cpu")
    assert welch_seen == [np.float64]


def test_one_host_copy_per_dtype(monkeypatch):
    recs = _ragged()[:3]
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append(self.dtype)
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    out = tbatch.analyze_records(recs, mode="flexible", max_candidates=8, device="cpu")
    assert len({rp.n_fft for rp in out}) == 2
    assert sorted(copies, key=str) == [torch.float32, torch.float32, torch.int32, torch.int32]


def test_records_validation_and_the_card_default(monkeypatch):
    with pytest.raises(ValueError, match="empty"):
        tbatch.analyze_records([(np.zeros(0), 500.0)], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs = _ragged()[:2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.analyze_records(recs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.analyze_records(recs, analyze=tpipe.SpectralPipeline())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.analyze_records_welch(recs, window=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.analyze_records_welch(recs, window=256,
                                     analyze=tpipe.SpectralPipeline().welch)


@pytest.mark.parametrize("mode", ["flexible", "rigid", "adaptive"])
def test_analyze_records_welch_matches_jax(mode):
    fs = 500.0
    tone = 125 * fs / 1024
    long = _noisy_tone(8192, fs, tone, 0.5, seed=1)
    longer = _noisy_tone(12288, fs, tone, 0.5, seed=2)
    recs = [(long, fs), (longer, 250.0), (long[:8192] * 0.5, fs)]
    calls = []
    got = tbatch.analyze_records_welch(recs, window=1024, mode=mode, refine=True,
                                       device="cpu",
                                       on_bucket=lambda n, idxs: calls.append((n, tuple(idxs))))
    want = jbatch.analyze_records_welch(recs, window=1024, mode=mode, refine=True)
    assert calls == [(1024, (0, 2)), (1024, (1,))]
    _assert_views_equal(got, want, mode)
    assert all(rp.count > 0 for rp in got)
    assert got[0].exact_freq(0, "flexible") == pytest.approx(tone, abs=0.3)


def test_analyze_records_welch_clamps_short_records_and_validates():
    short = _noisy_tone(512, 500.0, 62.5, 2.0, seed=4, noise=0.1)
    (rp,) = tbatch.analyze_records_welch([(short, 500.0)], window=1024, hop=600, device="cpu")
    (want,) = jbatch.analyze_records_welch([(short, 500.0)], window=1024, hop=600)
    assert rp.n_fft == 512
    _assert_views_equal([rp], [want], "flexible")
    assert rp.exact_freq(0, "flexible") == pytest.approx(62.5, abs=0.5)
    with pytest.raises(ValueError, match="window"):
        tbatch.analyze_records_welch([(np.zeros(64), 100.0)], window=1, device="cpu")
    with pytest.raises(ValueError, match="hop"):
        tbatch.analyze_records_welch([(np.zeros(64), 100.0)], window=32, hop=0, device="cpu")
    with pytest.raises(ValueError, match="fewer than 2"):
        tbatch.analyze_records_welch([(np.zeros(1), 100.0)], window=32, device="cpu")


@pytest.mark.parametrize("max_candidates", [None, 6])
def test_spectral_pipeline_welch_matches_jax(max_candidates):
    x = np.stack([_noisy_tone(16384, 500.0, 61.0352, 0.4, seed=s) for s in range(3)])
    cfg = dict(mode="adaptive", refine=True, max_candidates=max_candidates)
    pipe = tpipe.SpectralPipeline(tpipe.PipelineConfig(device="cpu", **cfg))
    jp = jpipe.SpectralPipeline(jpipe.PipelineConfig(dtype=jnp.float32, **cfg))
    got = pipe.welch(x, 500.0, window=2048, hop=1024)
    _assert_epoch_equal(got, jp.welch(x, 500.0, window=2048, hop=1024))
    for key in ("process_time", "wall_time", "percentage_cpu", "memrss"):
        assert key in pipe.last_metrics, key
    assert "candidate_budget" not in pipe.last_metrics  # Welch has no dynamic budget
    budget = max_candidates or tpipe.default_max_candidates(2048)
    direct = tstream.analyze_welch(x, 500.0, window=2048, hop=1024, mode="adaptive",
                                   refine=True, max_candidates=budget, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(direct, f)), f
    recs = tbatch.analyze_records_welch([(row, 500.0) for row in x], window=2048,
                                        analyze=pipe.welch)
    jrecs = jbatch.analyze_records_welch([(row, 500.0) for row in x], window=2048,
                                         analyze=jp.welch)
    _assert_views_equal(recs, jrecs, "adaptive")
