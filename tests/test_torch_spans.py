"""The port's spans (``utils.profiling.span``) on the CPU, and one on the card.

Untraced, no span builds a ``record_function``.  Under ``torch.profiler``
each stage of ``analyze_epoch`` shows as its span, nested as
``utils/profiling.py`` lists them, and the results are the same bits with
the profiler on and off.  The single-window route needs a CUDA device, so
the CPU tests pretend the window is on a card and count the route's
passes (``latency_cuda._route_pass``), as ``tests/test_torch_lowlat_routing.py``
does.  The module imports
no JAX, so its ``gpu`` test runs on the card:

    python -m pytest --noconftest tests/test_torch_spans.py -m gpu
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import apda_fft_tpu_torch.models.budget as B
import apda_fft_tpu_torch.models.pipeline as P
import apda_fft_tpu_torch.ops.latency_cuda as L
from apda_fft_tpu_torch.utils import profiling
from portbench.generators.sensor_windows import make_pool

FS = 500.0
CASES = ("batched", "route_flexible", "route_rigid", "retry", "handoff")


@pytest.fixture(autouse=True)
def _fresh_dynamic_state():
    saved = P.dynamic_state()
    P.reset_dynamic_state()
    yield
    P.load_dynamic_state(**saved)


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a single window is on a card; count the route's passes."""
    calls = []
    real = L._route_pass

    def counting_pass(*args, **kwargs):
        calls.append(kwargs.get("budget"))
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "_lowlat_device", lambda samples: True)
    monkeypatch.setattr(L, "_route_pass", counting_pass)
    return calls


def _modal(n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (np.sin(2 * np.pi * 0.025 * FS * t) + 0.6 * np.sin(2 * np.pi * 0.095 * FS * t)
         + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


def _past_the_cap() -> np.ndarray:
    """71 bin-exact tones: the walk needs 71 slots, past the route's 64, so
    the route hands the window to the batched path."""
    n = 4096
    t = np.arange(n) / FS
    return sum(np.sin(2 * np.pi * (b * FS / n) * t) for b in range(1100, 1313, 3)).astype(
        np.float32)


def _bound_past_cap() -> np.ndarray:
    """Row 1 of a seeded pool of ``bench.py``'s noisy model at N 4096: the
    pass at budget 2 reports its 74 candidates, past the route's 64, and the
    route re-runs it at 64, where the walk finishes at 10 slots."""
    signal = {"noise_std": 1.0, "modes": [[12.3, 0.9, 0.01], [47.7, 0.7, 0.008],
                                          [88.4, 0.55, 0.015], [141.2, 0.45, 0.02]]}
    return make_pool(signal, rows=64, n=4096, fs=FS, seed=0)[1]


def _epoch(case: str):
    """One ``analyze_epoch`` call of ``case`` on the CPU."""
    if case == "batched":
        x = np.random.default_rng(3).standard_normal((8, 1024)).astype(np.float32)
        return P.analyze_epoch(x, FS, mode="flexible", refine=True, device="cpu")
    if case == "route_flexible":
        return P.analyze_epoch(_modal(1024)[None], FS, mode="flexible", refine=True,
                               device="cpu")
    if case == "route_rigid":
        return P.analyze_epoch(_modal(1024)[None], FS, mode="rigid", device="cpu")
    if case == "retry":
        return P.analyze_epoch(_bound_past_cap()[None], FS, mode="flexible", refine=True,
                               device="cpu")
    assert case == "handoff"
    return P.analyze_epoch(_past_the_cap()[None], FS, mode="flexible", refine=True,
                           device="cpu")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _span_tree(prof) -> list:
    """The ``apda.*`` spans as ``(name, [children])`` trees, children in
    order of start: each span's parent is its nearest ``apda.*`` ancestor."""
    spans = sorted((e for e in prof.events() if e.name.startswith("apda.")),
                   key=lambda e: e.time_range.start)
    kids: dict[int, list] = {id(e): [] for e in spans}
    roots = []
    for e in spans:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("apda."):
            p = p.cpu_parent
        (kids[id(p)] if p is not None else roots).append(e)

    def tree(e):
        return (e.name, [tree(c) for c in kids[id(e)]])

    return [tree(e) for e in roots]


def _batched_passes(passes: int) -> tuple:
    one = [("apda.pass", [("apda.frontend", []), ("apda.detect", [("apda.refine", [])])]),
           ("apda.readback", [])]
    return ("apda.batched", one * passes)


def _route(calls: int, flexible: bool) -> tuple:
    one = [("apda.route.pass", [])] + ([("apda.route.readback", [])] if flexible else [])
    return ("apda.route", one * calls)


@pytest.mark.parametrize("case", CASES)
def test_untraced_spans_build_no_record_function(fake_card, monkeypatch, case):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("apda.epoch") is profiling.span("apda.place")
    res = _epoch(case)
    assert int(res.count.reshape(-1)[0]) >= 0
    assert (len(fake_card) > 0) == (case != "batched")


def test_span_is_record_function_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("apda.epoch"), torch.profiler.record_function)
    assert not isinstance(profiling.span("apda.epoch"), torch.profiler.record_function)


def test_batched_epoch_spans(fake_card):
    _, prof = _traced(lambda: _epoch("batched"))
    passes = P.last_dynamic_stats()["budget_passes"]
    assert fake_card == []
    assert _span_tree(prof) == [
        ("apda.epoch", [("apda.place", []), _batched_passes(passes)])]


@pytest.mark.parametrize("case", ["route_flexible", "route_rigid"])
def test_routed_window_spans(fake_card, case):
    _, prof = _traced(lambda: _epoch(case))
    flexible = case == "route_flexible"
    assert len(fake_card) >= 1
    if flexible:
        assert len(fake_card) == P.last_dynamic_stats()["budget_passes"]
    else:
        assert len(fake_card) == 1
    assert _span_tree(prof) == [
        ("apda.epoch", [("apda.place", []), _route(len(fake_card), flexible)])]


def test_retried_window_spans(fake_card):
    _, prof = _traced(lambda: _epoch("retry"))
    assert fake_card == [2, P.LOWLAT_MAX_BUDGET]
    assert P.last_dynamic_stats()["budget_passes"] == 2
    assert _span_tree(prof) == [
        ("apda.epoch", [("apda.place", []), _route(2, True)])]


def test_handed_off_window_spans(fake_card):
    _, prof = _traced(lambda: _epoch("handoff"))
    assert B._dynamic_budget[(4096, "flexible")] > P.LOWLAT_MAX_BUDGET
    passes = P.last_dynamic_stats()["budget_passes"]
    assert _span_tree(prof) == [
        ("apda.epoch", [("apda.place", []), _route(len(fake_card), True),
                        _batched_passes(passes)])]


def test_adaptive_prominence_pass_nests_its_epoch(fake_card):
    x = _modal(1024)
    _, prof = _traced(lambda: P.analyze_epoch(x[None], FS, mode="adaptive", device="cpu"))
    [(name, children)] = _span_tree(prof)
    assert name == "apda.epoch" and [c[0] for c in children] == ["apda.place", "apda.batched"]
    inner = children[1][1][0]
    assert inner[0] == "apda.epoch"
    assert [c[0] for c in inner[1]] == ["apda.place", "apda.route"]


def test_non_dyadic_rigid_table_is_placed_in_its_own_span():
    x = np.random.default_rng(5).standard_normal((4, 1024)).astype(np.float32)
    _, prof = _traced(lambda: P.analyze_epoch(x, 1000.0 / 3, mode="rigid", device="cpu"))
    [(name, children)] = _span_tree(prof)
    assert [c[0] for c in children] == ["apda.place", "apda.place", "apda.batched"]


@pytest.mark.parametrize("case", CASES)
def test_results_are_the_same_bits_traced_and_untraced(fake_card, case):
    plain = _epoch(case)
    learned = P.dynamic_state()
    P.reset_dynamic_state()
    traced, _ = _traced(lambda: _epoch(case))
    assert P.dynamic_state() == learned
    for field, a, b in zip(plain._fields, plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b), field


@pytest.mark.gpu
def test_route_kernel_starts_inside_its_pass_span_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rigid, flexible = _modal(1024), _modal(4096)

    def both():
        P.analyze_epoch(rigid[None], FS, mode="rigid")
        P.analyze_epoch(flexible[None], FS, mode="flexible", refine=True)

    both()  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        both()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted(e.time_range.start for e in events
                   if e.name == "apda.route.pass" and e.device_type.name == "CPU")
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type.name == "CUDA" and "lowlat_" in e.name)
    assert len(spans) >= 2 and len(kernels) == len(spans)
    for span_start, kernel_start in zip(spans, kernels):
        assert kernel_start >= span_start
