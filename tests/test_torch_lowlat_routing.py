"""``analyze_epoch``'s single-window routing decisions in the port, on the CPU.

The route needs a CUDA device, so these tests monkeypatch the port's device
predicate and swap the kernel entry for a counting wrapper that runs the
plain version (the window is on the CPU) - covering here the decision
logic that ``chip_smoke.py`` checks on the card end to end.  Each test is
the counterpart of one in ``tests/test_lowlat_routing.py``; the last one
runs the JAX package's faked-TPU route and the port's faked route on the
same windows and requires the same budgets per kernel call and the same
learned budgets afterwards.
"""

import jax
import numpy as np
import pytest

import apda_fft_tpu.models.pipeline as JP
import apda_fft_tpu.ops.latency_pallas as JL
import apda_fft_tpu_torch.models.pipeline as P
import apda_fft_tpu_torch.ops.latency_cuda as L
from apda_fft_tpu_torch.models.pipeline import analyze_epoch


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend the window is on a card; count kernel calls; isolate budgets."""
    calls = []
    real = L.analyze_window_lowlat

    def counting_kernel(*args, **kwargs):
        calls.append(kwargs.get("max_candidates"))
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "_lowlat_device", lambda samples: True)
    monkeypatch.setattr(L, "analyze_window_lowlat", counting_kernel)
    saved = P.dynamic_state()
    P.reset_dynamic_state()
    yield calls
    P.load_dynamic_state(**saved)


def _modal(n, fs=500.0, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = (
        np.sin(2 * np.pi * 0.025 * fs * t)
        + 0.6 * np.sin(2 * np.pi * 0.095 * fs * t)
        + 0.05 * rng.standard_normal(n)
    )
    return x.astype(np.float32)


def _same_decisions(a, b):
    assert int(a.count[0]) == int(b.count[0])
    assert np.array_equal(a.idx[0].numpy(), b.idx[0].numpy())


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
def test_single_full_window_routes_through_kernel(fake_card, mode):
    x = _modal(1024)
    routed = analyze_epoch(x[None], 500.0, mode=mode, device="cpu")
    n_routed_calls = len(fake_card)
    assert n_routed_calls >= 1
    unrouted = analyze_epoch(x[None], 500.0, mode=mode, lowlat="never", device="cpu")
    assert len(fake_card) == n_routed_calls  # "never" added no launches
    _same_decisions(routed, unrouted)


def test_lowlat_never_skips_kernel(fake_card):
    x = _modal(1024)
    analyze_epoch(x[None], 500.0, mode="flexible", lowlat="never", device="cpu")
    assert fake_card == []


def test_sticky_budget_past_cap_skips_kernel_attempt(fake_card):
    # A sticky budget past the 64-slot cap proves the kernel result would be
    # discarded; the routing must not pay the launch and readback.
    P._dynamic_budget[(1024, "flexible")] = 128
    x = _modal(1024)
    analyze_epoch(x[None], 500.0, mode="flexible", device="cpu")
    assert fake_card == []


def test_overflow_past_cap_falls_back_to_batched(fake_card):
    # 71 bin-exact tones above bin 1000: every candidate fails the damping
    # floor, so the walk never completes and n_required = n_candidates = 71
    # > the 64-slot cap.  The routing discards the kernel's result and the
    # batched dynamic path re-runs; decisions must match lowlat="never".
    fs, n = 500.0, 4096
    t = np.arange(n) / fs
    x = sum(
        np.sin(2 * np.pi * (b * fs / n) * t) for b in range(1100, 1313, 3)
    ).astype(np.float32)
    routed = analyze_epoch(x[None], fs, mode="flexible", device="cpu")
    assert len(fake_card) >= 1
    assert P._dynamic_budget[(4096, "flexible")] > P.LOWLAT_MAX_BUDGET
    unrouted = analyze_epoch(x[None], fs, mode="flexible", lowlat="never", device="cpu")
    _same_decisions(routed, unrouted)


def test_early_complete_walk_keeps_kernel_result_past_candidate_overflow(fake_card):
    # Noise window with more than 64 candidates whose greedy walk completes
    # within the first few slots: n_required is small, so the kernel result
    # is exact and kept, and the sticky budget stays under the cap.
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    routed = analyze_epoch(x[None], 500.0, mode="flexible", device="cpu")
    assert len(fake_card) >= 1
    assert int(routed.n_candidates.max()) > P.LOWLAT_MAX_BUDGET
    assert P._dynamic_budget[(4096, "flexible")] <= P.LOWLAT_MAX_BUDGET
    unrouted = analyze_epoch(x[None], 500.0, mode="flexible", lowlat="never", device="cpu")
    _same_decisions(routed, unrouted)


def test_adaptive_forwards_lowlat_never(fake_card):
    x = _modal(1024)
    res = analyze_epoch(x[None], 500.0, mode="adaptive", lowlat="never", device="cpu")
    assert fake_card == []
    assert int(res.count[0]) > 0


def test_adaptive_auto_routes_inner_flexible(fake_card):
    x = _modal(1024)
    res = analyze_epoch(x[None], 500.0, mode="adaptive", device="cpu")
    assert len(fake_card) >= 1
    assert int(res.count[0]) > 0


def test_batched_epochs_never_route(fake_card):
    x = np.stack([_modal(1024, seed=s) for s in range(3)])
    analyze_epoch(x, 500.0, mode="flexible", device="cpu")
    assert fake_card == []


def test_routing_decisions_match_jax(fake_card, monkeypatch):
    """The same windows through the JAX package's faked-TPU route and the
    port's faked route: the same budget per kernel call, the same learned
    budgets, the same decisions."""
    jax_calls = []
    real = JL.analyze_window_lowlat

    def counting_kernel(*args, **kwargs):
        jax_calls.append(kwargs.get("max_candidates"))
        return real(*args, **kwargs, interpret=True)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JL, "analyze_window_lowlat", counting_kernel)
    monkeypatch.setenv("APDA_FUSED_DETECTOR", "0")
    saved = dict(JP._dynamic_budget), dict(JP._dynamic_budget_hwm)
    JP._dynamic_budget.clear()
    JP._dynamic_budget_hwm.clear()
    try:
        noise = np.random.default_rng(11).standard_normal(1024).astype(np.float32)
        for x, mode in ((_modal(1024), "flexible"), (noise, "flexible"),
                        (_modal(1024, seed=2), "flexible"), (_modal(1024), "rigid")):
            want = JP.analyze_epoch(x[None], 500.0, mode=mode, dtype=np.float32)
            got = analyze_epoch(x[None], 500.0, mode=mode, device="cpu")
            assert int(got.count[0]) == int(want.count[0])
            assert np.array_equal(got.idx[0].numpy(), np.asarray(want.idx[0]))
        assert fake_card == jax_calls
        assert P._dynamic_budget == JP._dynamic_budget
        assert P._dynamic_budget_hwm == JP._dynamic_budget_hwm
    finally:
        JP._dynamic_budget.clear()
        JP._dynamic_budget_hwm.clear()
        JP._dynamic_budget.update(saved[0])
        JP._dynamic_budget_hwm.update(saved[1])
