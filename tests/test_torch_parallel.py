"""The port's sharded paths against the JAX package's, on the CPU.

The port's mesh is a single controller's: ``make_mesh(8, devices=["cpu"] *
8)`` gives eight logical shards on the host, where the JAX package runs on
the eight virtual CPU devices of the root ``conftest.py``.  The same numpy
inputs (from seeds) go through both sharded functions and through the
port's single-device run.  Tolerances:

* sharded epochs, under ``ROADMAP.md``'s "held against the reference"
  rule: ``count``, ``idx``, ``n_candidates`` and ``n_required`` equal to
  JAX's sharded run and to the port's single-device run; ``freq``, ``mag``,
  ``damping`` and ``q_factor`` within one step of their 4-/2-dp rounding
  (float32 may land on either side of a tie) plus rtol 1e-5; the other
  fields within rtol 1e-5, atol 1e-6 (the rule of the JAX package's own
  sharded-vs-single tests, ``tests/test_kernels_parallel.py:248-254``).
  Found here: at N >= 1024
  the shards give the single-device bits; at N = 256 the direct DFT's
  product differs in the last bit of a few magnitudes with the shard's
  batch size (oneDNN picks its kernel by shape), as cuBLAS may on the card;
* ``last_dynamic_stats()`` after a sharded dynamic call equal to JAX's
  sharded call's (budget, passes, maxima, tier);
* ``distributed_halfspec_magnitudes``: within 3e-6 of each row's maximum
  of JAX's at N=4096, 1e-5 at N=65536, and <= 1e-6 normwise against
  float64 ``numpy.fft``;
* ``correlation_blocks_sharded``: rtol 2e-5 plus 2e-5 of the largest entry
  against JAX's and the port's single-device blocks (``tests/test_ssi.py``);
* ``fdd(mesh=)``: count, idx and freq equal; ``sv1`` within rtol 1e-5 and
  shapes within rtol 1e-4, atol 1e-5 of both (``test_kernels_parallel.py``).
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import modal as jmodal
from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu.ops import fft as jfft
from apda_fft_tpu.parallel import distributed_fft as jdist
from apda_fft_tpu.parallel import mesh as jmesh
from apda_fft_tpu_torch.models import modal as tmodal
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.models import ssi as tssi
from apda_fft_tpu_torch.models import streaming as tstream
from apda_fft_tpu_torch.ops import fft as tfft
from apda_fft_tpu_torch.parallel import distributed_fft as tdist
from apda_fft_tpu_torch.parallel import mesh as tmesh
from apda_fft_tpu_torch.parallel.dryrun import dryrun_multichip
from tests.signals import modal_signal

DECISIONS = ("count", "idx", "n_candidates", "n_required")
#: The reference's rounding steps of the fields it rounds.
ROUND_STEP = {"freq": 1e-4, "mag": 1e-4, "damping": 1e-2, "q_factor": 1e-2}
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _fresh_budgets():
    for reset in (jpipe._dynamic_budget.clear, jpipe._dynamic_budget_hwm.clear,
                  jpipe._dynamic_tier.clear, tpipe.reset_dynamic_state):
        reset()
    yield
    tpipe.reset_dynamic_state()


def _mesh(shape=(8,), axes=("data",)):
    return (jmesh.make_mesh(8, axes, shape=shape),
            tmesh.make_mesh(8, axes, shape=shape, devices=CPU8))


def _windows(b, n, fs=500.0, seed=0):
    return np.stack([modal_signal(n, fs, seed=seed + i) for i in range(b)]).astype(np.float32)


def _noisy_corpus(b, n, fs=500.0, seed=1234, noise=1.0):
    """Noisy decaying modes (the two-tier trigger shape of
    ``tests/test_kernels_parallel.py``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = noise * rng.standard_normal((b, n)).astype(np.float64)
    for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008), (88.4, 0.55, 0.015)):
        phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
        x += a * np.sin(2 * np.pi * f * t[None, :] + phase) * np.exp(
            -zeta * 2 * np.pi * f * t[None, :])
    return x.astype(np.float32)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_epochs(port, jax_res, single, where):
    """The port's sharded epoch against JAX's sharded one and the port's
    single-device one (tolerances in the module docstring)."""
    for name in port._fields:
        p = _np(getattr(port, name))
        for other, want in (("single device", single), ("JAX", jax_res)):
            w = _np(getattr(want, name))
            assert p.shape == w.shape, (where, name, other, p.shape, w.shape)
            if name in DECISIONS:
                np.testing.assert_array_equal(p, w, err_msg=f"{where} {name} vs {other}")
            else:
                np.testing.assert_allclose(p, w, rtol=1e-5, atol=1.01 * ROUND_STEP.get(name, 0)
                                           or 1e-6, err_msg=f"{where} {name} vs {other}")


@pytest.mark.parametrize("mode,backend", [("flexible", "matmul"), ("rigid", "matmul"),
                                          ("adaptive", "matmul"), ("flexible", "pallas")])
def test_sharded_epoch_analysis_8dev(mode, backend):
    jm, tm = _mesh()
    xs = _windows(16, 1024)
    j = jmesh.analyze_epoch_sharded(xs, 500.0, mesh=jm, mode=mode, refine=True,
                                    backend=backend, max_candidates=32)
    p = tmesh.analyze_epoch_sharded(xs, 500.0, mesh=tm, mode=mode, refine=True,
                                    backend=backend, max_candidates=32)
    s = tpipe.analyze_epoch(xs, 500.0, mode=mode, refine=True, backend=backend,
                            max_candidates=32, device="cpu", batch_chunk=0)
    assert p.count.device.type == "cpu" and p.count.shape == (16,)
    _assert_epochs(p, j, s, f"{mode}/{backend}")


def test_sharded_multidim_batch_with_padding():
    """Leading batch shapes the mesh does not divide are padded, not refused."""
    jm, tm = _mesh()
    xs = np.stack([[modal_signal(256, 100.0, seed=3 * c + w) for w in range(4)]
                   for c in range(6)]).astype(np.float32)  # [6, 4, 256]: 6 % 8 != 0
    fs = np.full((6, 4), 100.0, np.float32)
    j = jmesh.analyze_epoch_sharded(xs, fs, mesh=jm, n_fft=256)
    p = tmesh.analyze_epoch_sharded(xs, fs, mesh=tm, n_fft=256)
    s = tpipe.analyze_epoch(xs, fs, n_fft=256, device="cpu", batch_chunk=0)
    assert p.count.shape == (6, 4)
    _assert_epochs(p, j, s, "multidim")
    assert dict(tpipe.last_dynamic_stats())["candidate_budget"] >= 2


def test_sharded_ragged_lengths_match_single_device():
    """Uneven batch AND uneven valid prefixes: padded, sharded and decided
    like the single-device pipeline (B=11 over 8 shards)."""
    jm, tm = _mesh()
    n_fft, b = 512, 11
    rng = np.random.default_rng(5)
    lengths = rng.integers(300, n_fft + 1, size=b)
    xs = np.zeros((b, n_fft), np.float32)
    for i, ln in enumerate(lengths):
        xs[i, :ln] = modal_signal(int(ln), 200.0, seed=100 + i)
    fs = np.full((b,), 200.0, np.float32)
    j = jmesh.analyze_epoch_sharded(xs, fs, mesh=jm, n_fft=n_fft, lengths=lengths)
    p = tmesh.analyze_epoch_sharded(xs, fs, mesh=tm, n_fft=n_fft, lengths=lengths)
    s = tpipe.analyze_epoch(xs, fs, n_fft=n_fft, lengths=lengths, device="cpu",
                            batch_chunk=0)
    assert p.count.shape == (b,)
    _assert_epochs(p, j, s, "ragged")


def test_sharded_adaptive_uneven_batch_matches_single_device():
    """Replicated pad rows do not force the adaptive rigid fallback; the
    non-dyadic rate takes the host wipe table on every shard."""
    jm, tm = _mesh()
    for fs0 in (100.0, 99.7):
        xs = np.stack([modal_signal(256, fs0, seed=40 + i) for i in range(5)]).astype(np.float32)
        fs = np.full((5,), fs0, np.float32)
        j = jmesh.analyze_epoch_sharded(xs, fs, mesh=jm, n_fft=256, mode="adaptive")
        jstats = dict(jpipe.last_dynamic_stats())
        p = tmesh.analyze_epoch_sharded(xs, fs, mesh=tm, n_fft=256, mode="adaptive")
        tstats = dict(tpipe.last_dynamic_stats())
        s = tpipe.analyze_epoch(xs, fs, n_fft=256, mode="adaptive", device="cpu",
                                batch_chunk=0)
        _assert_epochs(p, j, s, f"adaptive fs={fs0}")
        assert tstats == jstats, (tstats, jstats)


def test_sharded_welch_matches_single_device():
    """The channel axis sharded (11 channels over 8 shards)."""
    jm, tm = _mesh()
    c, window = 11, 1024
    records = _noisy_corpus(c, 8192, noise=0.8, seed=21)
    fs = np.full((c,), 500.0, np.float32)
    j = jmesh.analyze_welch_sharded(records, fs, window, mesh=jm)
    p = tmesh.analyze_welch_sharded(records, fs, window, mesh=tm)
    s = tstream.analyze_welch(records, fs, window, device="cpu")
    assert p.count.shape == (c,)
    _assert_epochs(p, j, s, "welch")


def _fdd_records():
    rng = np.random.default_rng(3)
    fs, t_len = 200.0, 16384
    t = np.arange(t_len) / fs
    shape1 = np.array([1.0, 0.8, 0.5, 0.2])
    shape2 = np.array([1.0, -0.3, -0.9, 0.6])
    drive1 = np.sin(2 * np.pi * 12.5 * t + rng.uniform(0, 6.28))
    drive2 = np.sin(2 * np.pi * 33.8 * t + rng.uniform(0, 6.28))
    return fs, (shape1[:, None] * drive1[None, :] + 0.7 * shape2[:, None] * drive2[None, :]
                + 0.05 * rng.standard_normal((4, t_len))).astype(np.float32)


def test_fdd_on_mesh_matches_single_device():
    """The per-bin power iteration split along frequency over 8 shards."""
    jm, tm = _mesh()
    fs, records = _fdd_records()
    j = jmodal.fdd(records, fs, window=1024, mesh=jm)
    p = tmodal.fdd(records, fs, window=1024, mesh=tm)
    s = tmodal.fdd(records, fs, window=1024, device="cpu")
    assert p.count == s.count == j.count and p.count >= 2
    for want in (s, j):
        np.testing.assert_array_equal(p.idx, want.idx)
        np.testing.assert_array_equal(p.freq, want.freq)
        np.testing.assert_allclose(p.sv1, want.sv1, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(p.shape_re, want.shape_re, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(p.shape_im, want.shape_im, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,n,noise", [(64, 4096, 1.0), (256, 2048, 2.0)])
def test_dynamic_two_tier_budget_on_mesh(b, n, noise):
    """The dynamic budget on the mesh: one loop over the whole padded
    batch, so budget, passes and learned tier equal JAX's sharded run; at
    B=256 (capacity 32, B >= 4 x 32) the first epoch learns a split and the
    second runs it, its stragglers picked over the whole batch."""
    jm, tm = _mesh()
    fs = np.full((b,), 500.0, np.float32)
    for epoch, seed in enumerate((11, 12)):
        x = _noisy_corpus(b, n, seed=seed, noise=noise)
        j = jmesh.analyze_epoch_sharded(x, fs, mesh=jm, n_fft=n, mode="flexible")
        jstats = dict(jpipe.last_dynamic_stats())
        p = tmesh.analyze_epoch_sharded(x, fs, mesh=tm, n_fft=n, mode="flexible")
        tstats = dict(tpipe.last_dynamic_stats())
        s = tpipe.analyze_epoch(x, fs, n_fft=n, mode="flexible", device="cpu", batch_chunk=0,
                                max_candidates=tstats["candidate_budget"])
        _assert_epochs(p, j, s, f"epoch {epoch}")
        assert tstats == jstats, (epoch, tstats, jstats)
    assert (n, "flexible") in tpipe.dynamic_state()["budget"]
    assert tpipe.dynamic_state()["budget"] == dict(jpipe._dynamic_budget)
    assert tpipe.dynamic_state()["tier"] == dict(jpipe._dynamic_tier)
    if b == 256:
        assert tstats["tier"] is not None, tstats


def test_sharded_two_tier_pass_matches_the_single_device_split():
    """One pass at a pinned two-tier budget, including a straggler count
    past the capacity: the merged ``n_required`` (the overflow report) and
    every decision equal the single-device ``_flex_detect``'s."""
    _, tm = _mesh()
    x = _noisy_corpus(256, 1024, seed=5)
    fs = np.full((256,), 500.0, np.float32)
    shards = list(zip(tmesh._blocks(torch.from_numpy(x), tm.axis_devices("data")),
                      tmesh._blocks(torch.from_numpy(fs), tm.axis_devices("data")),
                      [None] * 8, [None] * 8))
    mags = tpipe._epoch_spectra(torch.from_numpy(x), None, n_fft=1024, backend="matmul",
                                center="auto", taper="none", precision="highest")
    for tier in ((2, 64, 32), (4, 64, 32), (2, 64, 8)):
        got = tmesh._sharded_pass(shards, torch.device("cpu"), n_fft=1024, mode="flexible",
                                  k=4, backend="matmul", max_candidates=tier, refine=False,
                                  center="auto", taper="none", precision="highest")
        want = tpipe._detect_from_mags(mags, torch.from_numpy(fs), n_fft=1024, mode="flexible",
                                       k=4, max_candidates=tier, refine=False)
        for name in got._fields:
            np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                          err_msg=f"{tier} {name}")


def test_flagship_refined_dynamic_on_dpxsp_mesh():
    """The sequence-parallel FFT feeding the refined dynamic-budget detector
    on the (4, 2) mesh, against JAX's and the single-device flagship."""
    jm, tm = _mesh((4, 2), ("data", "seq"))
    n, b, fs = 4096, 16, 500.0
    xs = _windows(b, n, fs=fs)
    fs_b = np.full((b,), fs, np.float32)
    jw = jfft.center_and_pad(jnp.asarray(xs), n)
    jmags = jdist.distributed_halfspec_magnitudes(jdist.shard_windows_2d(jw, jm), jm)
    j = jpipe.detect_from_mags(jmags, fs_b, n_fft=n, mode="flexible", refine=True,
                               selection="sort")
    jstats = dict(jpipe.last_dynamic_stats())
    tw = tfft.center_and_pad(torch.from_numpy(xs), n)
    tmags = tdist.distributed_halfspec_magnitudes(tdist.shard_windows_2d(tw, tm), tm)
    p = tpipe.detect_from_mags(tmags, torch.from_numpy(fs_b), n_fft=n, mode="flexible",
                               refine=True)
    tstats = dict(tpipe.last_dynamic_stats())
    ref = tpipe.analyze_epoch(xs, fs_b, n_fft=n, mode="flexible", center="always",
                              refine=True, max_candidates=256, device="cpu")
    for name in ("count", "idx"):
        np.testing.assert_array_equal(_np(getattr(p, name)), _np(getattr(j, name)))
        np.testing.assert_array_equal(_np(getattr(p, name)), _np(getattr(ref, name)))
    assert int(p.count.min()) >= 1
    np.testing.assert_allclose(_np(p.refined_freq), _np(ref.refined_freq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(p.refined_freq), _np(j.refined_freq), rtol=1e-4, atol=1e-4)
    assert tstats == jstats, (tstats, jstats)


def test_gateway_pipeline_on_mesh(tmp_path):
    """A mesh-backed SpectralPipeline drives the port's gateway end to end."""
    from apda_fft_tpu_torch.gateway.config import GatewayConfig
    from apda_fft_tpu_torch.gateway.service import GatewayService
    from apda_fft_tpu_torch.gateway.transport import LoopbackTransport, SensorSimulator
    from apda_fft_tpu_torch.models.pipeline import PipelineConfig, SpectralPipeline
    from tests.signals import two_mode_signal

    data_dir = str(tmp_path / "d") + os.sep
    os.makedirs(data_dir)
    cfg_path = tmp_path / "gw.json"
    cfg_path.write_text(json.dumps({
        "ftp": {}, "fastapi": {"url": ""},
        "gateway": {"logger_file": data_dir + "h.log",
                    "device_file": data_dir + "dev.txt",
                    "config_file": str(tmp_path / "c.txt"),
                    "data_dir": data_dir,
                    "is_flexibile_structure": True},
    }))
    (tmp_path / "c.txt").write_text("")
    _, tm = _mesh()
    pipe = SpectralPipeline(PipelineConfig(mode="flexible"), mesh=tm)
    transport = LoopbackTransport()
    svc = GatewayService(GatewayConfig.load(cfg_path), transport, pipeline=pipe, device="cpu")
    svc.start()
    sim = SensorSimulator("a" * 16, fs=500.0, axis="X", chunk=100)
    sim.stream_acquisition(transport, two_mode_signal(1024, 500.0))
    svc.drain()
    entry = svc.fft_results["a" * 16]["X"]
    assert entry["peak_freq"] == 12.207  # 25 * 500/1024 rounded
    assert pipe.last_metrics["candidate_budget"] >= 2 and pipe.last_metrics["wall_time"] > 0


def test_spectral_pipeline_on_mesh_keeps_metrics():
    _, tm = _mesh()
    xs = _noisy_corpus(12, 1024, seed=3)
    pipe = tpipe.SpectralPipeline(tpipe.PipelineConfig(refine=True), mesh=tm)
    got = pipe(xs, 500.0)
    want = tpipe.analyze_epoch(xs, 500.0, refine=True, device="cpu",
                               max_candidates=pipe.last_metrics["candidate_budget"])
    for name in got._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)))
    assert {"wall_time", "candidate_budget", "budget_passes"} <= set(pipe.last_metrics)
    assert tpipe.last_dynamic_stats()["budget_passes"] == pipe.last_metrics["budget_passes"]


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_distributed_fft_matches_jax_and_float64(shape):
    jm, tm = _mesh(shape, ("data", "seq"))
    n = 4096
    xs = _windows(8, n)
    jw = jfft.center_and_pad(jnp.asarray(xs), n)
    want = np.asarray(jdist.distributed_halfspec_magnitudes(jdist.shard_windows_2d(jw, jm), jm))
    tw = tfft.center_and_pad(torch.from_numpy(xs), n)
    got = _np(tdist.distributed_halfspec_magnitudes(tw, tm))
    assert got.shape == (8, n // 2) and not got[:, 0].any()
    assert np.all(np.abs(got - want) <= 3e-6 * want.max(axis=-1, keepdims=True))
    ref = np.abs(np.fft.fft(_np(tw).astype(np.float64), axis=-1))[:, : n // 2]
    ref[:, 0] = 0.0
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6
    # The grid form gives the same result.
    grid = tdist.shard_windows_2d(tw, tm)
    assert len(grid) == shape[0] and len(grid[0]) == shape[1]
    np.testing.assert_array_equal(_np(tdist.distributed_halfspec_magnitudes(grid, tm)), got)


def test_distributed_fft_long_record():
    """N=65536 on the (2, 4) mesh (the beyond-VMEM design point)."""
    jm, tm = _mesh((2, 4), ("data", "seq"))
    n = 65536
    xs = _windows(2, n)
    jw = jfft.center_and_pad(jnp.asarray(xs), n)
    want = np.asarray(jdist.distributed_halfspec_magnitudes(jdist.shard_windows_2d(jw, jm), jm))
    got = _np(tdist.distributed_halfspec_magnitudes(
        tfft.center_and_pad(torch.from_numpy(xs), n), tm))
    assert np.all(np.abs(got - want) <= 1e-5 * want.max(axis=-1, keepdims=True))


def test_distributed_fft_rejects_bad_split():
    _, tm = _mesh((1, 8), ("data", "seq"))
    tdist.distributed_halfspec_magnitudes(tfft.center_and_pad(torch.from_numpy(
        _windows(2, 64)), 64), tm)  # N1 = N2 = 8: 8 divides
    with pytest.raises(ValueError, match="must divide"):
        tdist.distributed_halfspec_magnitudes(tfft.center_and_pad(torch.from_numpy(
            _windows(2, 16)), 16), tm)  # N1 = N2 = 4 < 8
    with pytest.raises(ValueError, match="power of two"):
        tdist.distributed_halfspec_magnitudes(torch.zeros(2, 8 * 12), tm)


def test_correlation_blocks_sharded_matches_jax_and_single_device():
    jm, tm = _mesh((8,), ("seq",))
    rng = np.random.default_rng(9)
    rec = (rng.standard_normal((4, 4096)) + 0.3).astype(np.float32)
    for detrend in ("mean", "none"):
        want_j = jmesh.correlation_blocks_sharded(rec, 32, jm, detrend=detrend)
        want_s = tssi.correlation_blocks(rec, 32, detrend=detrend, device="cpu")
        got = tmesh.correlation_blocks_sharded(rec, 32, tm, detrend=detrend)
        assert got.dtype == np.float64 and got.shape == (32, 4, 4)
        for want in (want_j, want_s):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    # The blocks feed ssi() as the single-device ones do.
    res = tssi.ssi(rec, 500.0, i=16, blocks=got)
    assert res.hankel_sv.shape[0] > 0


def test_correlation_blocks_sharded_rejections():
    jm, tm = _mesh((8,), ("seq",))
    rec = np.zeros((2, 4100), np.float32)
    for fn, m in ((jmesh.correlation_blocks_sharded, jm),
                  (tmesh.correlation_blocks_sharded, tm)):
        with pytest.raises(ValueError, match="divisible"):
            fn(rec, 16, m)
        with pytest.raises(ValueError, match="shorter than n_lags"):
            fn(np.zeros((2, 8 * 100), np.float32), 120, m)
        with pytest.raises(ValueError, match="n_lags must be"):
            fn(np.zeros((2, 800), np.float32), 1, m)
        with pytest.raises(ValueError, match="unknown detrend"):
            fn(np.zeros((2, 800), np.float32), 16, m, detrend="linear")


def test_pipelined_epochs_through_the_sharded_analysis():
    """``analyze_epochs_pipelined`` with the sharded epoch as its
    ``analyze`` hook equals the unsharded pipelined run."""
    _, tm = _mesh()
    epochs = [_noisy_corpus(20, 1024, seed=s) for s in range(4)]
    sharded = list(tstream.analyze_epochs_pipelined(
        epochs, 500.0, depth=2, device="cpu",
        analyze=functools.partial(tmesh.analyze_epoch_sharded, mesh=tm)))
    tpipe.reset_dynamic_state()
    plain = list(tstream.analyze_epochs_pipelined(epochs, 500.0, depth=2, device="cpu",
                                                  batch_chunk=0))
    for a, b in zip(sharded, plain):
        for name in a._fields:
            np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)))


def test_dryrun_multichip_on_eight_cpu_shards(capsys):
    line = dryrun_multichip(8, devices=CPU8)
    assert line.startswith("dryrun_multichip OK on 8 devices")
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_mesh_construction_and_shard_batch(monkeypatch):
    mesh = tmesh.make_mesh(8, ("data", "seq"), shape=(4, 2), devices=CPU8)
    assert mesh.shape == {"data": 4, "seq": 2}
    assert mesh.axis_devices("seq") == [torch.device("cpu")] * 2
    blocks = tmesh.shard_batch(np.arange(24.0).reshape(8, 3), mesh)
    assert [b.shape for b in blocks] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), np.arange(24.0).reshape(8, 3))
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(8, ("data", "seq"), shape=(3, 2), devices=CPU8)
    with pytest.raises(ValueError, match="not n_devices"):
        tmesh.make_mesh(4, devices=CPU8)
    # batch_chunk chunks within each shard and lowlat is accepted, as in the
    # JAX package: decisions equal JAX's sharded run and the single device.
    x = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)
    jm, tm = _mesh()
    want = jmesh.analyze_epoch_sharded(x, 500.0, mesh=jm, batch_chunk=64)
    single = tpipe.analyze_epoch(x, 500.0, device="cpu")
    for lowlat in ("auto", "never"):
        got = tmesh.analyze_epoch_sharded(x, 500.0, mesh=tm, batch_chunk=64, lowlat=lowlat)
        for name in ("idx", "count"):
            np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)))
            np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(single, name)))
    with pytest.raises(ValueError, match="unknown lowlat"):
        tmesh.analyze_epoch_sharded(_windows(8, 256), 500.0, mesh=mesh, lowlat="always")
    with pytest.raises(ValueError, match="unknown mode"):
        tmesh.analyze_epoch_sharded(_windows(8, 256), 500.0, mesh=mesh, mode="nope")
    empty = tmesh.analyze_epoch_sharded(np.zeros((0, 256), np.float32), 500.0, mesh=mesh)
    assert empty.count.shape == (0,)
    # A caller's tensor is never written: the pad and every shard copy.
    x = torch.from_numpy(_windows(5, 256))
    before = x.clone()
    tmesh.analyze_epoch_sharded(x, 500.0, mesh=mesh, refine=True)
    assert torch.equal(x, before)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.analyze_epoch_sharded(_windows(8, 256), 500.0)
