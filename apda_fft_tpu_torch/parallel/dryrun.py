"""A dry run of every sharded path, against the single-device pipeline.

Counterpart of ``__graft_entry__._dryrun_multichip_impl``.  It needs no
subprocess bootstrap: a mesh may repeat a device, so
``dryrun_multichip(8, devices=["cpu"] * 8)`` runs eight logical shards on
the CPU and ``dryrun_multichip(4, devices=["cuda:0"] * 4)`` four on one
card.
"""

from __future__ import annotations

import numpy as np
import torch

from apda_fft_tpu_torch.models import pipeline as _pipeline
from apda_fft_tpu_torch.models.modal import fdd
from apda_fft_tpu_torch.models.pipeline import analyze_epoch, detect_from_mags
from apda_fft_tpu_torch.models.ssi import correlation_blocks
from apda_fft_tpu_torch.models.streaming import analyze_welch
from apda_fft_tpu_torch.ops.fft import center_and_pad
from apda_fft_tpu_torch.parallel.distributed_fft import (
    distributed_halfspec_magnitudes,
    shard_windows_2d,
)
from apda_fft_tpu_torch.parallel.mesh import (
    analyze_epoch_sharded,
    analyze_welch_sharded,
    correlation_blocks_sharded,
    make_mesh,
)


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Drive both sharding axes at N=4096, B=8*n_devices, and hold each
    against the single-device run on the mesh's first device.

    * dp ("data"): the window batch sharded, flexible and rigid;
    * dp x sp ("data", "seq"): the sequence-parallel FFT feeding the static
      detector in both modes, then the refined dynamic-budget detector;
    * Welch over an uneven channel count, FDD with the bins sharded,
      adaptive mode under the dynamic budget, and the time-sharded SSI
      correlation blocks.

    Every epoch path uses ``center="always"`` so that all spectra share the
    median front end, and asserts full-decision parity: the count and every
    valid index.  ``devices`` as for :func:`make_mesh` (default: the
    visible cards).  Returns the summary line it prints.
    """
    mesh_dp = make_mesh(n_devices, devices=devices)
    dev0 = mesh_dp.first_device
    b, n, fs0 = 8 * n_devices, 4096, 500.0
    rng = np.random.default_rng(1)
    t = np.arange(n) / fs0
    samples = (
        np.sin(2 * np.pi * 12.3 * t)[None, :]
        + 0.6 * np.sin(2 * np.pi * 47.7 * t)[None, :]
        + 0.05 * rng.standard_normal((b, n))
    ).astype(np.float32)
    fs = np.full((b,), fs0, np.float32)

    def decisions(res):
        return res.count.cpu().numpy(), res.idx.cpu().numpy()

    ref = {
        mode: decisions(analyze_epoch(samples, fs, n_fft=n, mode=mode, center="always",
                                      device=dev0))
        for mode in ("flexible", "rigid")
    }

    def assert_decisions(tag, mode, cnt, idx):
        ref_cnt, ref_idx = ref[mode]
        assert np.array_equal(cnt, ref_cnt), (tag, mode, cnt, ref_cnt)
        for row in range(b):
            c = int(ref_cnt[row])
            assert np.array_equal(idx[row, :c], ref_idx[row, :c]), (tag, mode, row)

    for mode in ("flexible", "rigid"):
        cnt, idx = decisions(analyze_epoch_sharded(samples, fs, mesh=mesh_dp, mode=mode,
                                                   n_fft=n, center="always"))
        assert cnt.shape == (b,)
        assert_decisions("dp", mode, cnt, idx)

    seq = 2 if n_devices % 2 == 0 else 1
    mesh_2d = make_mesh(n_devices, ("data", "seq"), shape=(n_devices // seq, seq),
                        devices=mesh_dp.devices.reshape(-1))
    windows = center_and_pad(torch.from_numpy(samples).to(dev0), n)
    mags = distributed_halfspec_magnitudes(shard_windows_2d(windows, mesh_2d), mesh_2d)
    fs_t = torch.from_numpy(fs).to(dev0)
    total = 0
    for mode in ("flexible", "rigid"):
        det = _pipeline._detect_from_mags(
            mags, fs_t, n_fft=n, mode=mode, k=_pipeline.default_k(mode), max_candidates=32,
            refine=False)
        cnt, idx = decisions(det)
        assert cnt.shape == (b,)
        assert_decisions("dpxsp", mode, cnt, idx)
        total += int(cnt.sum())

    # The sequence-parallel FFT feeding the refined dynamic-budget detector,
    # against the single-device flagship on the same windows.
    flag_sh = detect_from_mags(mags, fs_t, n_fft=n, mode="flexible", refine=True)
    flag_stats = dict(_pipeline.last_dynamic_stats())
    flag_ref = analyze_epoch(samples, fs, n_fft=n, mode="flexible", center="always",
                             refine=True, max_candidates=256, batch_chunk=0, device=dev0)
    f_cnt, f_idx = decisions(flag_sh)
    assert_decisions("dpxsp-flagship", "flexible", f_cnt, f_idx)
    sh_rf, ref_rf = flag_sh.refined_freq.cpu().numpy(), flag_ref.refined_freq.cpu().numpy()
    for row in range(b):
        c = int(f_cnt[row])
        assert np.allclose(sh_rf[row, :c], ref_rf[row, :c], rtol=1e-4, atol=1e-4), (
            "dpxsp-flagship refined", row)
    assert flag_stats.get("candidate_budget", 0) >= 2, flag_stats

    cw = n_devices + 3  # uneven on purpose: the edge padding
    welch_rec = (
        np.sin(2 * np.pi * 12.3 * t)[None, :]
        + 0.6 * np.sin(2 * np.pi * 47.7 * t)[None, :]
        + 0.4 * rng.standard_normal((cw, n))
    ).astype(np.float32)
    welch_fs = np.full((cw,), fs0, np.float32)
    w_sh = analyze_welch_sharded(welch_rec, welch_fs, 1024, mesh=mesh_dp)
    w_ref = analyze_welch(welch_rec, welch_fs, 1024, device=dev0)
    w_cnt = w_ref.count.cpu().numpy()
    assert np.array_equal(w_sh.count.cpu().numpy(), w_cnt)
    for row in range(cw):
        c = int(w_cnt[row])
        assert np.array_equal(w_sh.idx[row, :c].cpu().numpy(),
                              w_ref.idx[row, :c].cpu().numpy()), ("welch", row)

    shape1 = np.array([1.0, 0.8, 0.5, 0.2])
    shape2 = np.array([1.0, -0.3, -0.9, 0.6])
    fdd_rec = (
        shape1[:, None] * np.sin(2 * np.pi * 12.3 * t)[None, :]
        + 0.7 * shape2[:, None] * np.sin(2 * np.pi * 47.7 * t)[None, :]
        + 0.05 * rng.standard_normal((4, n))
    ).astype(np.float32)
    f_sh = fdd(fdd_rec, fs0, window=1024, mesh=mesh_dp)
    f_ref = fdd(fdd_rec, fs0, window=1024, device=dev0)
    assert f_sh.count == f_ref.count and f_ref.count >= 2, ("fdd", f_sh.count, f_ref.count)
    assert np.array_equal(f_sh.idx, f_ref.idx), ("fdd idx", f_sh.idx, f_ref.idx)
    assert np.allclose(f_sh.shape_re, f_ref.shape_re, rtol=1e-4, atol=1e-5)

    noisy = (samples + 0.8 * rng.standard_normal((b, n))).astype(np.float32)
    d_sh = analyze_epoch_sharded(noisy, fs, mesh=mesh_dp, n_fft=n, mode="adaptive")
    dyn_stats = dict(_pipeline.last_dynamic_stats())
    d_ref = analyze_epoch(noisy, fs, n_fft=n, mode="adaptive", batch_chunk=0,
                          max_candidates=256, device=dev0)
    assert np.array_equal(d_sh.count.cpu().numpy(), d_ref.count.cpu().numpy())
    assert np.array_equal(d_sh.idx.cpu().numpy(), d_ref.idx.cpu().numpy())
    assert dyn_stats.get("candidate_budget", 0) >= 2, dyn_stats

    mesh_seq = make_mesh(n_devices, ("seq",), devices=mesh_dp.devices.reshape(-1))
    rec = rng.standard_normal((4, 512 * n_devices)).astype(np.float32)
    blocks_ref = correlation_blocks(rec, 32, device=dev0)
    blocks_sh = correlation_blocks_sharded(rec, 32, mesh_seq)
    assert np.allclose(blocks_sh, blocks_ref, rtol=2e-5,
                       atol=2e-5 * np.abs(blocks_ref).max()), (
        "seq-sharded correlation blocks diverge", float(np.abs(blocks_sh - blocks_ref).max()))

    line = (
        f"dryrun_multichip OK on {n_devices} devices ({mesh_dp}) at N={n}/B={b} "
        f"(2d mesh {mesh_2d.shape}): full-decision parity flexible+rigid on both meshes, "
        f"{total} dpxsp peaks, refined+dynamic dpxsp flagship parity "
        f"(budget {flag_stats.get('candidate_budget')}, {int(f_cnt.sum())} peaks), "
        f"welch sharded parity (C={cw}), fdd freq-sharded parity ({int(f_ref.count)} modes), "
        f"adaptive+dynamic-budget parity (budget {dyn_stats.get('candidate_budget')}), "
        f"seq-sharded SSI correlations matched"
    )
    print(line)
    return line
