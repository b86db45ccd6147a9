"""Spectra longer than a block's shared memory: N >= 131072 on the detector kernels.

The select+scan kernel (B1, ``csrc/prominence_select_scan.cu``) and the
scans kernel (B5, ``csrc/prominence_scans.cu``) keep a row of up to
``kSharedMaxH`` bins in shared memory; a longer row takes a second
instantiation of each kernel that reads the row from device memory.  Checked
here on the CPU:

* that instantiation's host plan, mirrored from the sources' constants: its
  shared part (the candidate list with its pick slots, then the chunk
  summaries while they fit) stays inside the 227 KB a block may use for
  every H from the first long row to 2**20, and the summaries go to the
  global workspace past what fits;
* the port's ``analyze_epoch`` at N = 131072 in flexible and adaptive mode
  against the JAX package's and the float64 oracle (on the CPU the detector
  runs its plain twin).

``test_torch_gpu_card.py`` runs the same epochs on the card against the CPU
run; ``chip_smoke.py`` (phases 3, 5 and 12) covers the kernels there.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu.models import pipeline as jpipe
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.ops import detector_cuda
from apda_fft_tpu_torch.utils import kernels
from tests.oracle import oracle_analyze
from tests.signals import modal_signal

BLOCK_SMEM = 227 * 1024  # bytes of shared memory a block may use on Hopper
FS = 500.0
N_LONG = 131072


def _constant(source: str, name: str) -> int:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        text = f.read()
    expr = re.search(rf"constexpr \w+ {name} = ([0-9 *+\-]+);", text).group(1)
    return int(eval(expr))  # a constant expression of integers from the source


MAX_LIST = _constant("walk_common.cuh", "kMaxList")
#: (source, static shared bytes kept beside the dynamic part, bytes of the
#: candidate list and pick slots a long row keeps in shared memory).
KERNELS = {
    "select_scan": ("prominence_select_scan.cu", 1024, 12 * MAX_LIST),
    "scans": ("prominence_scans.cu", 0, 0),
}


def long_plan(kernel: str, b: int, h: int) -> dict:
    """``plan()`` of the kernel's source for a row past ``kSharedMaxH``."""
    source, _, list_bytes = KERNELS[kernel]
    cap = _constant(source, "kSmemCap")
    sums = 8 * ((h + 31) // 32)
    in_smem = list_bytes + sums <= cap
    return {"smem": list_bytes + (sums if in_smem else 0),
            "ws_floats": 0 if in_smem else b * sums // 4, "summaries_smem": in_smem, "cap": cap}


def shared_max_h(kernel: str) -> int:
    source = KERNELS[kernel][0]
    return _constant(source, "kSmemCap") // 4


LONG_HS = [57857, 58113, 65536, 131072, 262144, 524288, 729088, 729089, 929792, 929793, 1 << 20]


@pytest.mark.parametrize("kernel, h", [(k, h) for k in sorted(KERNELS) for h in LONG_HS
                                       if h > shared_max_h(k)])
def test_long_row_plan_fits(kernel, h):
    _, static, _ = KERNELS[kernel]
    plan = long_plan(kernel, 16, h)
    assert plan["cap"] + static == BLOCK_SMEM
    assert plan["smem"] + static <= BLOCK_SMEM
    n_chunks = (h + 31) // 32
    if plan["summaries_smem"]:
        assert plan["ws_floats"] == 0
    else:
        assert plan["ws_floats"] == 16 * 2 * n_chunks
    # Where the summaries first leave shared memory: ~729 K bins for the
    # select+scan kernel (beside its list), ~930 K for the scans kernel.
    first_out = {"select_scan": 729089, "scans": 929793}[kernel]
    assert plan["summaries_smem"] == (h < first_out)


def test_long_rows_start_past_the_shared_route():
    # The select+scan kernel keeps 1 KB of static scratch; the scans kernel none.
    assert shared_max_h("select_scan") == 57856
    assert shared_max_h("scans") == 58112
    assert not hasattr(detector_cuda, "_check_h") and not hasattr(detector_cuda, "MAX_H")


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
