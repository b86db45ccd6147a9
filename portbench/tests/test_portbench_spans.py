"""The readers of the port's spans (``harness/spans.py`` and the four
span metrics' readers, listed in ``BENCHMARK.json`` or not) on made-up
traces, and on a small traced run of the clean epoch on the CPU."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import cell as cellmod  # noqa: E402
from portbench.harness import loop  # noqa: E402
from portbench.harness import spans  # noqa: E402
from portbench.harness.trace import TraceSlice  # noqa: E402

SPAN_METRICS = ("place_ms.epoch", "pass_host_ms.epoch", "route_host_ms.window",
                "route_pass_yield.window")


def _run(host, requests, config=None):
    sl = TraceSlice(device=[], host=sorted(host, key=lambda e: (e[1], -e[2])),
                    requests=requests)
    return loop.Run(config=config or {}, setup_s=1.0, window_s=1.0,
                    latencies_s=np.ones(len(requests)), windows=np.ones(len(requests)),
                    trace=sl)


def _read(name, run):
    return cellmod.metric_reader(name).read(run)


def _epochs():
    """Two epochs: 3 + 1 us placing, 40 + 60 us in passes (two in the
    second), 10 us in a readback; an aten operation that reads nothing."""
    host = [("apda.epoch", 0.0, 100.0), ("apda.place", 1.0, 4.0), ("aten::copy_", 1.5, 3.5),
            ("apda.batched", 5.0, 99.0), ("apda.pass", 6.0, 46.0), ("apda.readback", 50.0, 60.0),
            ("apda.epoch", 110.0, 200.0), ("apda.place", 111.0, 112.0),
            ("apda.batched", 113.0, 199.0), ("apda.pass", 114.0, 144.0),
            ("apda.pass", 150.0, 180.0)]
    return _run(host, [("portbench.request", 0.0, 105.0), ("portbench.request", 105.0, 205.0)])


def _windows():
    """Four windows: the first served by one pass of 20 us with a 5 us
    readback; the second by two passes (a re-run), route 30 us with readbacks
    of 4 + 4 us; the third handed off after one pass (route and batched); the
    fourth on the batched path alone."""
    host = [
        ("apda.epoch", 0.0, 50.0), ("apda.place", 1.0, 2.0), ("apda.route", 3.0, 23.0),
        ("apda.route.pass", 4.0, 12.0), ("apda.route.readback", 13.0, 18.0),
        ("apda.epoch", 100.0, 150.0), ("apda.route", 103.0, 133.0),
        ("apda.route.pass", 104.0, 110.0), ("apda.route.readback", 111.0, 115.0),
        ("apda.route.pass", 116.0, 120.0), ("apda.route.readback", 121.0, 125.0),
        ("apda.epoch", 200.0, 290.0), ("apda.route", 203.0, 223.0),
        ("apda.route.pass", 204.0, 210.0), ("apda.route.readback", 211.0, 215.0),
        ("apda.batched", 224.0, 280.0), ("apda.pass", 225.0, 260.0),
        ("apda.epoch", 300.0, 390.0), ("apda.batched", 304.0, 380.0),
    ]
    reqs = [("portbench.request", 100.0 * i, 100.0 * i + 95.0) for i in range(4)]
    return _run(host, reqs)


def test_each_reader_gives_its_exact_value():
    epochs, windows = _epochs(), _windows()
    assert _read("place_ms.epoch", epochs) == pytest.approx((3 + 1) / 1e3 / 2)
    assert _read("pass_host_ms.epoch", epochs) == pytest.approx((40 + 30 + 30) / 1e3 / 2)
    # Served: (20 - 5) and (30 - 4 - 4) us; the hand-off and the batched
    # window are not counted.
    assert _read("route_host_ms.window", windows) == pytest.approx((15 + 22) / 2 / 1e3)
    # Two served windows over four kernel calls.
    assert _read("route_pass_yield.window", windows) == pytest.approx(50.0)


def test_spans_group_by_the_request_that_holds_their_start():
    groups = spans.per_request(_windows().trace)
    assert [len(g) for g in groups] == [5, 6, 6, 2]
    assert [spans.routed(g) for g in groups] == [True, True, False, False]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_spans_reads_none(name):
    requests = [("portbench.request", 0.0, 50.0), ("portbench.request", 50.0, 100.0)]
    assert _read(name, _run([("aten::copy_", 1.0, 2.0)], requests)) is None
    assert _read(name, _run([], [])) is None
    untraced = _run([], requests)
    untraced.trace = None
    assert _read(name, untraced) is None


def test_the_route_metrics_read_none_without_a_served_request():
    host = [("apda.epoch", 0.0, 90.0), ("apda.route", 1.0, 5.0),
            ("apda.route.pass", 2.0, 4.0), ("apda.batched", 6.0, 80.0)]
    run = _run(host, [("portbench.request", 0.0, 95.0)])
    assert _read("route_host_ms.window", run) is None
    assert _read("route_pass_yield.window", run) == 0.0


def test_a_traced_clean_epoch_on_the_cpu_reads_both_host_metrics():
    c = cellmod.load_cell("footbridge_n4096.epoch_clean")
    c.traffic.update(pool_windows=48, windows_per_request=16, warmup_requests=1,
                     trace_requests=3, keep_every=1)
    result = loop.execute(c, 2**32 + 17, 0.2, True, t0=time.perf_counter(), device="cpu")
    got = {name: _read(name, result["run"]) for name in ("place_ms.epoch", "pass_host_ms.epoch")}
    assert got["place_ms.epoch"] > 0 and got["pass_host_ms.epoch"] > 0
    # Placing three epochs of 16 windows takes far less than their passes.
    assert got["place_ms.epoch"] < got["pass_host_ms.epoch"]
