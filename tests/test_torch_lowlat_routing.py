"""``analyze_epoch``'s single-window routing decisions in the port, on the CPU.

The route needs a CUDA device, so these tests monkeypatch the port's device
predicate and swap the route's per-pass entry (``latency_cuda._route_pass``)
for a counting wrapper; on the CPU that entry runs the plain version, laid
out as the kernels lay out their results - covering here the decision
logic that ``chip_smoke.py`` checks on the card end to end.  Each test but
one is the counterpart of one in ``tests/test_lowlat_routing.py``; the last
one runs the JAX package's faked-TPU route and the port's faked route on
the same windows and requires the same budgets per kernel call and the same
learned budgets afterwards.  ``test_bound_past_cap_retries_at_cap`` has no
JAX counterpart: the JAX route hands a window off as soon as a pass reports
more than 64 slots (its kernel's compile time grows with the budget), while
the port's route re-runs it at 64 first, so the two route such a window
differently; its decisions are held against the JAX package's batched path.
"""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import apda_fft_tpu.models.pipeline as JP
import apda_fft_tpu.ops.latency_pallas as JL
import apda_fft_tpu_torch.models.budget as B
import apda_fft_tpu_torch.models.pipeline as P
import apda_fft_tpu_torch.ops.latency_cuda as L
import apda_fft_tpu_torch.ops.peaks_resolution as R
from apda_fft_tpu_torch.models.pipeline import analyze_epoch
from apda_fft_tpu_torch.ops.peaks_resolution import rigid_half_corrections
from apda_fft_tpu_torch.utils.placement import fs_tensor
from portbench.generators.sensor_windows import make_pool


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend the window is on a card; count the route's passes; isolate budgets."""
    calls = []
    real = L._route_pass

    def counting_pass(*args, **kwargs):
        calls.append(kwargs.get("budget"))
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "_lowlat_device", lambda samples: True)
    monkeypatch.setattr(L, "_route_pass", counting_pass)
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


def _bound_past_cap():
    """Row 1 of a seeded pool of ``bench.py``'s noisy model (unit noise and
    four damped modes; N 4096 at 500 Hz): 74 candidates.  A pass at budget 2
    or 8 stops its walk short and reports all 74, past the 64-slot cap; the
    pass at 64 finishes its walk at 10 slots."""
    signal = {"noise_std": 1.0, "modes": [[12.3, 0.9, 0.01], [47.7, 0.7, 0.008],
                                          [88.4, 0.55, 0.015], [141.2, 0.45, 0.02]]}
    return make_pool(signal, rows=64, n=4096, fs=500.0, seed=0)[1]


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
    B._dynamic_budget[(1024, "flexible")] = 128
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
    assert fake_card == [2, P.LOWLAT_MAX_BUDGET]  # the retry at the cap, then the hand-off
    assert B._dynamic_budget[(4096, "flexible")] > P.LOWLAT_MAX_BUDGET
    unrouted = analyze_epoch(x[None], fs, mode="flexible", lowlat="never", device="cpu")
    _same_decisions(routed, unrouted)


def test_a_need_past_half_the_cap_is_learned_whole(fake_card):
    # 40 bin-exact tones above bin 1000 that all fail the damping floor: the
    # walk never completes, so n_required = n_candidates = 40.  The route
    # re-runs at the cap and serves the window there; the sticky budget
    # learns 64, the need's power of two, as the batched path learns it.
    fs, n = 500.0, 4096
    t = np.arange(n) / fs
    x = sum(
        np.sin(2 * np.pi * (b * fs / n) * t) for b in range(1100, 1220, 3)
    ).astype(np.float32)
    routed = analyze_epoch(x[None], fs, mode="flexible", device="cpu")
    assert fake_card == [2, P.LOWLAT_MAX_BUDGET]
    assert int(routed.n_required[0]) == 40
    assert P.dynamic_state()["budget"] == {(4096, "flexible"): 64}
    P.reset_dynamic_state()
    unrouted = analyze_epoch(x[None], fs, mode="flexible", lowlat="never", device="cpu")
    _same_decisions(routed, unrouted)
    assert P.dynamic_state()["budget"] == {(4096, "flexible"): 64}


def test_bound_past_cap_retries_at_cap(fake_card, monkeypatch):
    # A pass at the sticky budget 8 reports the candidate count, 74, past
    # the cap: a bound, not the need.  The route re-runs the window at the
    # cap, where the walk finishes, and serves it with no batched pass.
    x = _bound_past_cap()
    B._dynamic_budget[(4096, "flexible")] = 8

    def no_batched_pass(*args, **kwargs):
        raise AssertionError("the batched path ran")

    with monkeypatch.context() as m:
        m.setattr(P, "_run_dynamic", no_batched_pass)
        routed = analyze_epoch(x[None], 500.0, mode="flexible", refine=True, device="cpu")
    assert fake_card == [8, P.LOWLAT_MAX_BUDGET]
    stats = P.last_dynamic_stats()
    assert stats["candidate_budget"] == P.LOWLAT_MAX_BUDGET and stats["budget_passes"] == 2
    assert stats["n_candidates_max"] > P.LOWLAT_MAX_BUDGET >= stats["n_required_max"]
    assert B._dynamic_budget[(4096, "flexible")] <= P.LOWLAT_MAX_BUDGET
    unrouted = analyze_epoch(x[None], 500.0, mode="flexible", refine=True, lowlat="never",
                             device="cpu")
    assert len(fake_card) == 2
    _same_decisions(routed, unrouted)
    # The JAX package's batched path with every bin of the half spectrum a slot.
    want = JP.analyze_epoch(x[None], 500.0, mode="flexible", refine=True, max_candidates=2048,
                            dtype=np.float32)
    assert int(routed.count[0]) == int(want.count[0])
    assert np.array_equal(routed.idx[0].numpy(), np.asarray(want.idx[0]))


def test_early_complete_walk_keeps_kernel_result_past_candidate_overflow(fake_card):
    # Noise window with more than 64 candidates whose greedy walk completes
    # within the first few slots: n_required is small, so the kernel result
    # is exact and kept, and the sticky budget stays under the cap.
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    routed = analyze_epoch(x[None], 500.0, mode="flexible", device="cpu")
    assert len(fake_card) >= 1
    assert int(routed.n_candidates.max()) > P.LOWLAT_MAX_BUDGET
    assert B._dynamic_budget[(4096, "flexible")] <= P.LOWLAT_MAX_BUDGET
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
        assert B._dynamic_budget == JP._dynamic_budget
        assert B._dynamic_budget_hwm == JP._dynamic_budget_hwm
    finally:
        JP._dynamic_budget.clear()
        JP._dynamic_budget_hwm.clear()
        JP._dynamic_budget.update(saved[0])
        JP._dynamic_budget_hwm.update(saved[1])


def _cell_pool(config: str, rows: int = 64, seed: int = 2_900_000_017):
    """A window cell's configuration and ``rows`` windows of its traffic
    (``portbench/configs``, ``portbench/traffic/window_noisy.json``)."""
    root = Path(__file__).resolve().parents[1] / "portbench"
    cfg = json.loads((root / "configs" / f"{config}.json").read_text())
    signal = json.loads((root / "traffic" / "window_noisy.json").read_text())["signal"]
    return cfg, make_pool(signal, rows=rows, n=cfg["n_fft"], fs=cfg["fs"], seed=seed)


def _assert_same_fields(got, want):
    for field, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("config", ["tunnel_n1024", "footbridge_n4096"])
def test_route_fields_equal_the_batched_path_and_the_public_wrapper(fake_card, config):
    """Every field of the route's result, as its per-pass entry lays it out,
    against ``lowlat="never"`` and the public ``analyze_window_lowlat`` at
    the route's final budget, on 64 windows of the cell's traffic."""
    cfg, pool = _cell_pool(config)
    fs, kw = cfg["fs"], dict(mode=cfg["mode"], k=cfg["k"], refine=cfg["refine"])
    for row in pool:
        passes = len(fake_card)
        routed = analyze_epoch(row[None], fs, device="cpu", **kw)
        assert len(fake_card) > passes  # served by the route, not handed off
        budget = P.last_dynamic_stats().get("candidate_budget", P.LOWLAT_MAX_BUDGET)
        public = L.analyze_window_lowlat(torch.from_numpy(row), fs, max_candidates=budget, **kw)
        _assert_same_fields(routed, public)
        _assert_same_fields(routed, analyze_epoch(row[None], fs, device="cpu", lowlat="never",
                                                  **kw))


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
def test_a_held_route_result_is_not_written_by_the_next_request(fake_card, mode):
    cfg, pool = _cell_pool("footbridge_n4096", rows=2)
    first = analyze_epoch(pool[0][None], 500.0, mode=mode, refine=True, device="cpu")
    kept = [t.clone() for t in first]
    second = analyze_epoch(pool[1][None], 500.0, mode=mode, refine=True, device="cpu")
    assert len(fake_card) >= 2
    firsts = {t.untyped_storage().data_ptr() for t in first}
    assert not firsts & {t.untyped_storage().data_ptr() for t in second}
    for field, a, b in zip(first._fields, first, kept):
        assert torch.equal(a, b), field


def test_route_calls_count_passes_and_public_calls(fake_card):
    before = dict(L.route_calls)
    B._dynamic_budget[(4096, "flexible")] = 8
    analyze_epoch(_bound_past_cap()[None], 500.0, mode="flexible", device="cpu")  # two passes
    analyze_epoch(_modal(1024)[None], 500.0, mode="rigid", device="cpu")  # one pass
    assert fake_card == [8, P.LOWLAT_MAX_BUDGET, B.FLOOR]
    assert L.route_calls == {"internal": before["internal"] + 3, "public": before["public"]}
    L.analyze_window_lowlat(torch.from_numpy(_modal(1024)), 500.0, mode="rigid")
    L.analyze_window_lowlat(torch.from_numpy(_modal(1024)[None]), 500.0, mode="flexible")
    analyze_epoch(_modal(1024)[None], 500.0, mode="rigid", lowlat="never", device="cpu")
    assert L.route_calls == {"internal": before["internal"] + 3, "public": before["public"] + 2}


@pytest.mark.parametrize("fs, lead", [(1000.0 / 3, (4,)), (99.7, (2, 3)),
                                      (np.array([500.0, 99.7, 1000.0 / 3]), (3,))])
def test_a_cached_wipe_table_is_not_written_by_a_non_dyadic_rigid_epoch(fs, lead):
    n = 1024
    x = np.random.default_rng(5).standard_normal(lead + (n,)).astype(np.float32)
    rates = np.broadcast_to(np.asarray(fs, np.float64), lead).reshape(-1)
    res = analyze_epoch(x, fs, mode="rigid", device="cpu")
    want = analyze_epoch(x, fs, mode="rigid", device="cpu")
    _assert_same_fields(res, want)
    for v in rates:
        cached, fresh = R._half_corrections(float(v), n), rigid_half_corrections(float(v), n)
        if fresh is None:
            assert cached is None
            continue
        assert not cached.flags.writeable
        assert np.array_equal(cached, fresh)
        with pytest.raises(ValueError):
            cached[0] += 1


def test_a_scalar_rate_is_filled_once_per_value():
    a = fs_tensor(500.0, torch.float32, torch.device("cpu"))
    assert fs_tensor(np.float64(500.0), torch.float32, torch.device("cpu")) is a
    assert a.shape == () and a.dtype == torch.float32 and float(a) == 500.0
    assert fs_tensor(500.0, torch.float64, torch.device("cpu")) is not a
    zero, minus_zero = (fs_tensor(v, torch.float32, "cpu") for v in (0.0, -0.0))
    assert math.copysign(1.0, float(minus_zero)) == -1.0 != math.copysign(1.0, float(zero))
    assert math.isnan(float(fs_tensor(math.nan, torch.float32, "cpu")))
