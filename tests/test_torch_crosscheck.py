"""The cross-check algorithms of the port against the paths they check and
the JAX package's, on the CPU, and the n_required contract.

* ``median_lastaxis(method="select")`` (radix selection) against
  ``method="sort"`` (and, on the first 8 trials, the JAX package's select:
  it compiles per shape), equal values on random,
  tie-heavy, non-negative and signed-zero rows, full and ragged
  (``tests/test_stats_median.py``'s corpus);
* ``prominence_peaks(scan_impl="sparse")`` against ``"masked"`` and the JAX
  package's sparse scans on adversarial spectra (plateaus, exact ties,
  monotone runs, spikes: ``tests/test_peaks_match.py``'s cases): every
  field equal to the masked scans, decisions equal to JAX's;
* ``tests/test_peaks_match.py::test_n_required_is_the_smallest_exact_budget``
  on the port: at ``max_candidates == n_required`` the decisions are the
  unbounded ones and the float64 oracle's, at any smaller budget the
  result reports ``n_required`` above it, and ``n_required <=
  n_candidates``; the JAX package gives the same ``n_required``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apda_fft_tpu import analyze_epoch as janalyze
from apda_fft_tpu.ops import peaks_prominence as jprom
from apda_fft_tpu.ops.stats import median_lastaxis as jmedian
from apda_fft_tpu_torch.models import pipeline as tpipe
from apda_fft_tpu_torch.ops import peaks_prominence as tprom
from apda_fft_tpu_torch.ops.stats import median_lastaxis
from tests.oracle import oracle_analyze
from tests.signals import modal_signal


@pytest.fixture(autouse=True)
def _fresh_budgets():
    tpipe.reset_dynamic_state()
    yield
    tpipe.reset_dynamic_state()


def _median_rows(trial: int, rng):
    b = int(rng.integers(1, 6))
    n = int(rng.choice([7, 16, 127, 1024, 1025, 4096]))
    x = rng.standard_normal((b, n)).astype(np.float32) * rng.uniform(1e-3, 1e3)
    kind = trial % 4
    if kind == 1:
        x = np.round(x)  # heavy ties
    elif kind == 2:
        x = np.abs(x)
    elif kind == 3:
        x[:, ::3] = -0.0
        x[:, 1::3] = 0.0
    return x, rng.integers(1, n + 1, size=b).astype(np.int32)


def test_median_select_matches_sort_and_jax():
    rng = np.random.default_rng(0)
    for trial in range(40):
        x, lengths = _median_rows(trial, rng)
        t = torch.from_numpy(x)
        for length in (None, lengths):
            tl = None if length is None else torch.from_numpy(length)
            jl = None if length is None else jnp.asarray(length)
            got = median_lastaxis(t, tl, method="select").numpy()
            np.testing.assert_array_equal(got, median_lastaxis(t, tl, method="sort").numpy())
            np.testing.assert_array_equal(got, median_lastaxis(t, tl).numpy())
            if trial < 8:  # each kind twice: the JAX side compiles per shape
                np.testing.assert_array_equal(
                    got, np.asarray(jmedian(jnp.asarray(x), jl, method="select")))


def test_median_method_validation():
    with pytest.raises(ValueError, match="unknown method"):
        median_lastaxis(torch.zeros((2, 8)), method="quickselect")
    with pytest.raises(ValueError, match="float32 only"):
        median_lastaxis(torch.zeros((2, 8), dtype=torch.float64), method="select")


def _adversarial(seed: int, rng) -> np.ndarray:
    h = [64, 128, 512][seed % 3]
    m = rng.uniform(0, 1, h)
    m[h // 4: h // 4 + 5] = 0.8
    m[h // 2] = 5.0
    m[h // 2 + 2] = 5.0
    m[3 * h // 4:] = np.linspace(1.2, 0.0, h - 3 * h // 4)
    m[0] = 0.0
    return m.astype(np.float32)


@pytest.mark.parametrize("seed", range(12))
def test_sparse_scans_match_masked_and_jax(seed):
    m = _adversarial(seed, np.random.default_rng(3 + seed))
    h = m.shape[-1]
    t = torch.from_numpy(np.stack([m, np.round(m * 8) / 8]))
    sparse = tprom.prominence_peaks(t, 500.0, 2 * h, scan_impl="sparse")
    masked = tprom.prominence_peaks(t, 500.0, 2 * h, scan_impl="masked")
    for name in masked._fields:
        assert torch.equal(getattr(sparse, name), getattr(masked, name)), name
    for row in range(t.shape[0]):
        want = jprom.prominence_peaks(jnp.asarray(t[row].numpy()), 500.0, 2 * h,
                                      scan_impl="sparse")
        c = int(want.count)
        assert int(sparse.count[row]) == c
        np.testing.assert_array_equal(sparse.idx[row, :c].numpy(), np.asarray(want.idx)[:c])
        np.testing.assert_allclose(sparse.prominence[row, :c].numpy(),
                                   np.asarray(want.prominence)[:c], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scan_impl"):
        tprom.prominence_peaks(t, 500.0, 2 * h, scan_impl="dense")


@pytest.mark.parametrize("seed,n,fs", [(7, 4096, 500.0), (11, 4096, 250.0), (3, 8192, 62.5)])
def test_n_required_is_the_smallest_exact_budget(seed, n, fs):
    rng = np.random.default_rng(seed)
    x = (modal_signal(n, fs, seed=seed) + 0.3 * rng.standard_normal(n)).astype(np.float32)

    def run(budget):
        return tpipe.analyze_epoch(x[None], fs, mode="flexible", max_candidates=budget,
                                   lowlat="never", device="cpu")

    full = run(n // 2)
    nreq, ncand = int(full.n_required[0]), int(full.n_candidates[0])
    assert 1 <= nreq <= ncand
    jfull = janalyze(x[None], fs, mode="flexible", max_candidates=n // 2, lowlat="never")
    assert (int(jfull.n_required[0]), int(jfull.n_candidates[0])) == (nreq, ncand)
    want = [p["idx"] for p in oracle_analyze(x, fs, mode="flexible")]
    for budget in (nreq, nreq + 3):
        res = run(budget)
        assert res.idx[0, :int(res.count[0])].tolist() == want, (seed, budget)
        assert int(res.n_required[0]) == nreq
    if nreq > 1:
        assert int(run(nreq - 1).n_required[0]) > nreq - 1
