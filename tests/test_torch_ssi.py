"""The port's SSI-COV identification against the JAX package and the truth.

``apda_fft_tpu_torch/models/ssi.py`` computes the correlation blocks in
torch (IEEE float32 products) and identifies on the host in float64 numpy,
re-stated from the JAX package.  Inputs are made with numpy from a seed and
run through both packages on the CPU.  Tolerances (measured worst case on
these corpora in brackets):

* ``correlation_blocks``: within 4e-6 of the largest block entry of the
  JAX package's [2e-6] and 2e-6 of float64 numpy's
  (``tests/test_ssi.py:52``);
* ``ssi`` on the port's own blocks: the same number of modes as the JAX
  package, ``n_orders`` within 1 (the float32 blocks differ in the last
  bits, and a pole at the edge of a tolerance can join or leave a
  cluster and move its medians), frequencies within rtol 2e-5 plus the
  cluster's spread ``freq_std`` [5e-5 relative, 0.06 of the spread],
  dampings within rtol 1e-2 plus ``damping_std`` [2e-3 relative], shapes
  at MAC >= 0.9999 [>= 0.999997]; against the truth the JAX tests' bounds
  (frequency within 0.5%, damping within 25%, MAC > 0.95);
* ``ssi`` on injected blocks, and the host helpers: bit-equal.
"""

import numpy as np
import pytest
import torch

from apda_fft_tpu.models import ssi as jssi
from apda_fft_tpu.utils.synthetic import modal_records
from apda_fft_tpu_torch.models import ssi as tssi
from apda_fft_tpu_torch.models.modal import modal_assurance

SHAPES = np.array([[1.0, 0.8, 0.5, 0.2], [0.9, 0.1, -0.6, -1.0]])
FREQS, ZETAS = (3.1, 7.6), (0.01, 0.02)


def _line_shapes(s: int) -> np.ndarray:
    return np.array([np.sin(np.pi * (m + 1) * (np.arange(s) + 1) / (s + 1)) for m in range(3)])


#: name -> (records [S, T], fs, ssi keywords, (freqs, zetas, shapes) or None)
CORPORA = {
    "two modes": (modal_records(SHAPES, FREQS, ZETAS, 50.0, 240.0, seed=3), 50.0, {},
                  (FREQS, ZETAS, SHAPES)),
    "orders 2..40": (modal_records(SHAPES, FREQS, ZETAS, 50.0, 120.0, seed=6), 50.0,
                     dict(orders=range(2, 41, 2)), (FREQS, ZETAS, SHAPES)),
    "one channel": (modal_records(np.array([[1.0]]), [3.1], [0.01], 50.0, 240.0, seed=4), 50.0,
                    {}, None),
    "white noise": (np.random.default_rng(0).standard_normal((4, 12000)).astype(np.float32),
                    50.0, {}, None),
    "no detrend, i 15": (modal_records(SHAPES, FREQS, ZETAS, 50.0, 240.0, seed=5) + 0.3, 50.0,
                         dict(detrend="none", i=15), (FREQS, ZETAS, SHAPES)),
    "gateway, 8 sensors": (
        modal_records(_line_shapes(8) * np.array([1.0, 2.0, 4.0])[:, None], (12.3, 31.7, 58.9),
                      (0.01, 0.015, 0.02), 500.0, 16384 / 500.0, seed=9), 500.0, {},
        ((12.3, 31.7, 58.9), (0.01, 0.015, 0.02), _line_shapes(8))),
}


@pytest.mark.parametrize("s,t,n_lags,detrend", [(3, 5000, 12, "mean"), (4, 4000, 8, "none"),
                                                (8, 16384, 40, "mean"), (1, 2000, 2, "mean")])
def test_correlation_blocks_match_jax_and_float64(s, t, n_lags, detrend):
    rng = np.random.default_rng(s * t)
    x = (rng.standard_normal((s, t)) + 0.5).astype(np.float32)
    got = tssi.correlation_blocks(torch.from_numpy(x), n_lags, detrend=detrend)
    want = jssi.correlation_blocks(x, n_lags, detrend=detrend)
    assert got.dtype == np.float64 and got.shape == want.shape == (n_lags, s, s)
    assert np.abs(got - want).max() <= 4e-6 * np.abs(want).max()
    xm = x.astype(np.float64)
    if detrend == "mean":
        xm -= xm.mean(-1, keepdims=True)
    t0 = t - n_lags + 1
    for lag in range(n_lags):
        ref = xm[:, lag : lag + t0] @ xm[:, :t0].T / t0
        assert np.abs(got[lag] - ref).max() <= 2e-6 * np.abs(ref).max(), lag


def _assert_modes_close(got, want, case):
    assert got.count == want.count, (case, got.freqs(), want.freqs())
    for a, b in zip(got.modes, want.modes):
        assert abs(a.n_orders - b.n_orders) <= 1, case
        # A pole joining or leaving moves a cluster's medians by up to its spread.
        assert abs(a.freq - b.freq) <= 2e-5 * b.freq + b.freq_std, (case, a.freq, b.freq)
        assert abs(a.damping - b.damping) <= 1e-2 * b.damping + b.damping_std, \
            (case, a.damping, b.damping)
        assert modal_assurance(a.shape, b.shape)[0, 0] >= 0.9999, case
        assert a.mpc == pytest.approx(b.mpc, abs=1e-4)
    np.testing.assert_allclose(got.hankel_sv, want.hankel_sv, rtol=0,
                               atol=1e-5 * want.hankel_sv.max())
    np.testing.assert_array_equal(got.orders, want.orders)
    assert got.n_sensors == want.n_sensors and len(got.diagram) == len(want.diagram)


@pytest.mark.parametrize("case", list(CORPORA))
def test_ssi_matches_jax_and_the_truth(case):
    x, fs, kw, truth = CORPORA[case]
    got = tssi.ssi(torch.from_numpy(x), fs, **kw)
    want = jssi.ssi(x, fs, **kw)
    _assert_modes_close(got, want, case)
    if case == "white noise":
        assert got.count == 0 and got.shapes().shape == (0, 4)
    if truth is not None:
        freqs, zetas, shapes = truth
        assert got.count == len(freqs), (case, got.freqs())
        for mode, f, z, shape in zip(got.modes, freqs, zetas, shapes):
            assert abs(mode.freq - f) / f < 5e-3, (case, mode.freq, f)
            assert abs(mode.damping - 100 * z) / (100 * z) < 0.25, (case, mode.damping, z)
            assert modal_assurance(mode.shape, shape)[0, 0] > 0.95, case


@pytest.mark.parametrize("case", ["two modes", "one channel", "gateway, 8 sensors"])
def test_ssi_on_injected_blocks_is_bit_equal(case):
    """Given the same correlation blocks, the host identification is the
    JAX package's to the bit: modes, diagram and Hankel spectrum."""
    x, fs, kw, _ = CORPORA[case]
    blocks = jssi.correlation_blocks(x, 2 * kw.get("i", 20))
    got = tssi.ssi(x, fs, blocks=blocks, **kw)
    want = jssi.ssi(x, fs, blocks=blocks, **kw)
    assert len(got.modes) == len(want.modes)
    for a, b in zip(got.modes, want.modes):
        assert a._fields == b._fields
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(got.hankel_sv, want.hankel_sv)
    for dg, dw in zip(got.diagram, want.diagram):
        assert dg.keys() == dw.keys()
        for k in dg:
            np.testing.assert_array_equal(dg[k], dw[k])


def test_ssi_host_helpers_bit_equal():
    rng = np.random.default_rng(5)
    for phi in (np.array([1.0, -2.0, 0.5]), np.exp(1j * rng.uniform(0, 6, 5)),
                rng.standard_normal(4) + 1j * rng.standard_normal(4), np.zeros(3)):
        assert tssi.modal_phase_collinearity(phi) == jssi.modal_phase_collinearity(phi)
        np.testing.assert_array_equal(tssi._phase_fix_host(phi), jssi._phase_fix_host(phi))
    r = rng.standard_normal((12, 3, 3))
    np.testing.assert_array_equal(tssi._block_hankel(r, 6), jssi._block_hankel(r, 6))
    u, sv, _ = np.linalg.svd(tssi._block_hankel(r, 6))
    for order in (2, 6, 12):
        for a, b in zip(tssi._poles_at_order(u, sv, 3, order, 50.0, 0.2),
                        jssi._poles_at_order(u, sv, 3, order, 50.0, 0.2)):
            np.testing.assert_array_equal(a, b)
    modes = [jssi.SSIMode(f, 1.0, np.array([1.0, 0.5 + 0.01 * i]), 10, n, 0.0, 0.0, 1.0)
             for i, (f, n) in enumerate(((7.513, 5), (7.596, 27), (9.0, 3)))]
    np.testing.assert_equal(tssi._merge_close_modes(modes, 0.01, 0.95),
                            jssi._merge_close_modes(modes, 0.01, 0.95))


def test_ssi_validation_matches_jax():
    x = np.zeros((2, 100), np.float32)
    cases = [
        lambda m, **k: m.correlation_blocks(x, 1, **k),
        lambda m, **k: m.correlation_blocks(x, 30, **k),
        lambda m, **k: m.correlation_blocks(np.zeros(100, np.float32), 4, **k),
        lambda m, **k: m.correlation_blocks(x, 4, detrend="median", **k),
        lambda m, **k: m.ssi(x, 0.0, **k),
        lambda m, **k: m.ssi(x, 50.0, i=1, **k),
        lambda m, **k: m.ssi(np.zeros(100, np.float32), 50.0, **k),
        lambda m, **k: m.ssi(x, 50.0, i=2, orders=[4], **k),
        lambda m, **k: m.ssi(x, 50.0, i=3, orders=[], **k),
        lambda m, **k: m.ssi(x, 50.0, orders=[1, 2], **k),
        lambda m, **k: m.ssi(x, 50.0, min_orders=0, **k),
        lambda m, **k: m.ssi(x, 50.0, mpc_min=1.5, **k),
        lambda m, **k: m.ssi(x, 50.0, i=3, blocks=np.zeros((5, 2, 2)), **k),
    ]
    for call in cases:
        with pytest.raises(ValueError) as je:
            call(jssi)
        with pytest.raises(ValueError) as te:
            call(tssi, device="cpu")
        assert str(te.value) == str(je.value)


def test_ssi_runs_arrays_on_the_card_by_default(monkeypatch):
    """Without ``device`` the blocks of an array are computed on CUDA, so
    without a card it raises; a CPU tensor runs where it lies; injected
    blocks need no device at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, fs, _, _ = CORPORA["two modes"]
    for call in (lambda a: tssi.ssi(a, fs), lambda a: tssi.correlation_blocks(a, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x)
        call(torch.from_numpy(x))
    blocks = jssi.correlation_blocks(x, 40)
    assert tssi.ssi(x, fs, blocks=blocks).count == 2
