"""Spectra longer than a block's shared memory: N >= 131072 on the detector kernels.

The select+scan kernel (B1, ``csrc/prominence_select_scan.cu``) and the
scans kernel (B5, ``csrc/prominence_scans.cu``) keep a row of up to
``kSharedMaxH`` bins in shared memory; a longer row takes a cluster kernel:
one thread-block cluster of ``kClusterSize`` CTAs a row
(``csrc/cluster_common.cuh``), CTA r holding segment r of the row.  Checked
here on the CPU:

* the cluster plan, mirrored from the sources' constants: each CTA's shared
  memory (its list, winners, pick slots and chunk summaries, then its
  segment while that fits) stays inside the 227 KB a block may use for
  every H from the first long row to 2**20 at any budget; the segments are
  chunk-aligned, cover [0, H) and depend on H alone, as the plain twin's
  threshold order (``ops/stats.py``) takes them; the segment leaves shared
  memory where the plan says;
* the port's ``analyze_epoch`` at N = 131072 in flexible and adaptive mode
  against the JAX package's and the float64 oracle (on the CPU the detector
  runs its plain twin).

``test_torch_gpu_card.py`` runs the cluster kernels against their twins and
the same epochs on the card; ``chip_smoke.py`` (phases 3, 5, 12 and 26)
covers the kernels there.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.ops import detector_cuda, stats
from apda_fft_tpu_torch.utils import kernels
from tests.oracle import oracle_analyze
from tests.signals import modal_signal

BLOCK_SMEM = 227 * 1024  # bytes of shared memory a block may use on Hopper
FS = 500.0
N_LONG = 131072


def _source(source: str) -> str:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        return f.read()


def _constant(source: str, name: str) -> int:
    expr = re.search(rf"constexpr \w+ {name} = ([0-9 *+\-]+);", _source(source)).group(1)
    return int(eval(expr))  # a constant expression of integers from the source


MAX_LIST = _constant("walk_common.cuh", "kMaxList")
CLUSTER = _constant("cluster_common.cuh", "kClusterSize")
STRIDE = _constant("cluster_common.cuh", "kSegmentStride")
WARPS = _constant("prominence_select_scan.cu", "kMaxThreads") // 32
#: (source, static shared bytes kept beside the dynamic part).
KERNELS = {
    "select_scan": ("prominence_select_scan.cu", 1024),
    "scans": ("prominence_scans.cu", 0),
}


def segment_bins(h: int) -> int:
    """``segment_bins()`` of ``cluster_common.cuh``."""
    return (h + CLUSTER * STRIDE - 1) // (CLUSTER * STRIDE) * STRIDE


def cluster_plan(kernel: str, h: int, m: int) -> dict:
    """The cluster kernel's plan of one CTA's dynamic shared memory at
    (h, m), from its source's constants."""
    cap = _constant(KERNELS[kernel][0], "kSmemCap")
    seg = segment_bins(h)
    per = seg // 32
    if kernel == "scans":
        seg_smem = 8 * per + 4 * seg <= cap
        seg_bytes = 4 * seg if seg_smem else 0
        whole = 8 * CLUSTER * per + seg_bytes <= cap
        return {"seg": seg, "seg_smem": seg_smem, "whole": whole, "cap": cap,
                "smem": 8 * (CLUSTER if whole else 1) * per + seg_bytes}
    warps = CLUSTER * WARPS
    fixed = 8 * MAX_LIST + 8 * MAX_LIST + 4 * (CLUSTER * MAX_LIST // warps * WARPS)
    seg_smem = fixed + 8 * per + 4 * (seg + 8) <= cap
    seg_bytes = 4 * (seg + 8) if seg_smem else 0
    whole = fixed + 8 * CLUSTER * per + seg_bytes <= cap
    win = (min(m, MAX_LIST) + 1) & ~1
    picks = -(-min(m, CLUSTER * MAX_LIST) // warps) * WARPS
    return {"seg": seg, "seg_smem": seg_smem, "whole": whole, "cap": cap,
            "smem": 8 * MAX_LIST + 8 * win + 8 * (CLUSTER if whole else 1) * per + 4 * picks
            + seg_bytes}


def shared_max_h(kernel: str) -> int:
    source = KERNELS[kernel][0]
    return _constant(source, "kSmemCap") // 4


#: The longest rows whose segment stays in a CTA's shared memory.
SEGMENT_SMEM_MAX_H = {"select_scan": 280576, "scans": 437248}
#: The rows whose CTAs each hold the whole row's chunk summaries: while they
#: fit beside the segment, and again past it while they fit alone.
WHOLE_SUMMARIES = {"select_scan": ((57857, 198656), (280577, 598016)),
                   "scans": ((58113, 309248), (437249, 929792))}
LONG_HS = [57857, 58113, 65536, 131072, 198656, 198657, 262144, 280576, 280577, 309248,
           309249, 437248, 437249, 524288, 598016, 598017, 729088, 729089, 929792, 929793,
           1 << 20]


@pytest.mark.parametrize("kernel, h", [(k, h) for k in sorted(KERNELS) for h in LONG_HS
                                       if h > shared_max_h(k)])
def test_long_row_plan_fits(kernel, h):
    _, static = KERNELS[kernel]
    for m in (1, 2, 32, 128, 4096, h):
        plan = cluster_plan(kernel, h, m)
        assert plan["cap"] + static == BLOCK_SMEM
        assert plan["smem"] + static <= BLOCK_SMEM, (m, plan)
    # Chunk-aligned segments, in rank order, covering [0, h); the last one
    # is shorter but not empty.
    seg = plan["seg"]
    assert seg % 32 == 0 and seg % 4 == 0
    bounds = [(r * seg, min((r + 1) * seg, h)) for r in range(CLUSTER)]
    assert bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # The twin's threshold order takes the same segments.
    assert stats.threshold_segment(h) == seg and stats.THRESHOLD_CLUSTER == CLUSTER
    assert plan["seg_smem"] == (h <= SEGMENT_SMEM_MAX_H[kernel])
    assert plan["whole"] == any(lo <= h <= hi for lo, hi in WHOLE_SUMMARIES[kernel])


def test_cluster_size_depends_on_h_alone():
    # kClusterSize is a constant (8, a portable cluster size), the segments
    # a function of h alone: no batch, budget or device enters them.
    assert CLUSTER == 8 == detector_cuda.CLUSTER_SIZE
    assert re.search(r"int segment_bins\(int h\)", _source("cluster_common.cuh"))
    for name, _ in KERNELS.values():
        text = _source(name)
        assert "segment_bins(h)" in text
        assert "cudaLaunchAttributeClusterDimension" not in text  # one launcher
    launcher = _source("cluster_common.cuh")
    assert "cudaLaunchAttributeClusterDimension" in launcher
    assert "cudaOccupancyMaxActiveClusters" in launcher


def test_long_rows_start_past_the_shared_route():
    # The select+scan kernel keeps 1 KB of static scratch; the scans kernel none.
    assert shared_max_h("select_scan") == 57856 == stats.THRESHOLD_SHARED_MAX_H
    assert shared_max_h("scans") == 58112
    assert detector_cuda.SELECT_SCAN_SHARED_MAX_H == shared_max_h("select_scan")
    assert detector_cuda.SCANS_SHARED_MAX_H == shared_max_h("scans")
    assert not hasattr(detector_cuda, "_check_h") and not hasattr(detector_cuda, "MAX_H")


def test_one_kernel_per_route():
    # The one-block long-row kernels and their workspace are gone.
    for name, _ in KERNELS.values():
        text = _source(name)
        assert "_long_kernel" not in text and "workspace" not in text
        assert "cluster_kernel" in text
    assert "noise_threshold_long" not in _source("prominence_select_scan.cu")
    assert not hasattr(detector_cuda, "_workspace")


def _long_epoch() -> np.ndarray:
    """Two N = 131072 windows: four lightly damped modes near 10, 18, 30 and
    45 Hz (the prominence detector accepts all four within its first few
    candidates), and two undamped tones on exact bins (their one-bin peaks
    fail its damping floor, so adaptive mode falls back to the resolution
    detector)."""
    rng = np.random.default_rng(5)
    modes = [(f * rng.uniform(0.96, 1.04), rng.uniform(1.0, 2.0), rng.uniform(0.002, 0.004))
             for f in (10.0, 18.0, 30.0, 45.0)]
    t = np.arange(N_LONG) / FS
    tones = (np.sin(2 * np.pi * (3000 * FS / N_LONG) * t + 0.3)
             + 0.6 * np.sin(2 * np.pi * (11000 * FS / N_LONG) * t + 1.1)
             + 0.05 * rng.standard_normal(N_LONG) + 0.1)
    return np.stack([modal_signal(N_LONG, FS, modes=modes, noise=0.01, seed=5),
                     tones]).astype(np.float32)


@pytest.fixture
def _fresh_dynamic_state():
    def reset():
        jpipe._dynamic_budget.clear()
        jpipe._dynamic_budget_hwm.clear()
        jpipe._dynamic_tier.clear()
        tpipe.reset_dynamic_state()

    reset()
    yield
    reset()


@pytest.mark.usefixtures("_fresh_dynamic_state")
@pytest.mark.parametrize("mode", ["flexible", "adaptive"])
def test_epoch_at_n_131072_matches_jax_and_oracle(mode):
    x = _long_epoch()
    got = tpipe.analyze_epoch(torch.from_numpy(x), FS, mode=mode, refine=True, lowlat="never")
    want = jpipe.analyze_epoch(jnp.asarray(x), FS, mode=mode, refine=True, lowlat="never",
                               dtype=jnp.float32)
    for f in ("count", "idx", "n_candidates", "n_required"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("freq", "mag"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=1e-6, err_msg=f)
    counts = got.count.tolist()
    assert counts[0] == 4
    if mode == "adaptive":
        assert counts[1] > 0  # the resolution detector's fallback
    else:
        assert counts[1] == 0
    for i in range(2):
        ref = oracle_analyze(x[i].astype(np.float64), FS, mode)
        assert got.idx[i, :counts[i]].tolist() == [p["idx"] for p in ref], i
