"""The harness on the CPU: the cells resolve, the file obeys the
benchmark's rules, the generators repeat, the yardstick matches the
port's work formulas, the result line has its keys, a window counts
requests when told to and seconds otherwise, every entry keeps its output
contract, a broken timed path fails the check; and, on the card
(``gpu``), one whole run and the control."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import cell as cellmod  # noqa: E402
from portbench.harness import loop, report, roofline  # noqa: E402
from portbench.harness.trace import TraceSlice  # noqa: E402
from portbench.tests.cpu_cells import REQUESTS, small  # noqa: E402

BENCH = cellmod.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FIVE = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    c = cellmod.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", entry["traffic"] + ".json"))
    assert os.path.isfile(os.path.join(ROOT, "portbench", "limits", name + ".json"))
    assert os.path.isfile(os.path.join(ROOT, c.config["reference"]))
    assert os.path.isfile(os.path.join(ROOT, "portbench", "entries", c.config["entry"] + ".py"))
    assert os.path.isfile(os.path.join(ROOT, "portbench", "generators",
                                       c.traffic["generator"] + ".py"))
    assert c.chips in (1, 4) and c.end_to_end and c.per_layer
    assert "setup_s" in [m.name for m in c.end_to_end]
    assert len(c.end_to_end) >= 2
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)


def test_benchmark_file_obeys_the_rules():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert all(0 < len(cfg[k]) <= 200 and "\n" not in cfg[k] for k in ("source", "why"))
        assert cfg["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(ROOT, cfg["file"]))
        names.append(cfg["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
        names += [w["name"], w["traffic"]]
    # Of the cells at most a quarter, rounded down, or one, take four cards.
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(BENCH["workloads"]) // 4, 1)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
        for w in m["workloads"]:
            mover = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in mover.get("workloads", CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got)), kind
    assert len(json.dumps(BENCH)) < 64 * 1024


TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "portbench", "traffic")))


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_generators_repeat_for_a_seed_and_differ_across_seeds(traffic):
    with open(os.path.join(ROOT, "portbench", "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    generator = cellmod._module("generators", mix["generator"], ("make_pool",))
    kw = dict(rows=8, n=1024, fs=500.0)
    seed = 2**31 + 12345
    a = generator.make_pool(mix["signal"], seed=seed, **kw)
    b = generator.make_pool(mix["signal"], seed=seed, **kw)
    other = generator.make_pool(mix["signal"], seed=seed + 1, **kw)
    assert a.dtype == np.float32 and a.shape == (8, 1024)
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    assert mix["order"] in loop.ORDERS
    for order in loop.ORDERS:
        s1 = loop.request_starts(order, 50, 64, 16, seed, 1)
        assert np.array_equal(s1, loop.request_starts(order, 50, 64, 16, seed, 1))
        assert ((s1 >= 0) & (s1 <= 48)).all()


def test_frozen_yardstick_equals_the_ports_work_formulas():
    from apda_fft_tpu_torch.ops import fft_cuda, latency_cuda

    for n, k in ((1024, 5), (4096, 4), (65536, 4)):
        assert roofline.lowlat_bytes(n, k) == latency_cuda.lowlat_work(n, k)[0]
        assert roofline.rfft_mag_flops(n) == fft_cuda.rfft_mag_flops(n)


def test_metric_readers_on_a_made_up_trace():
    cell = cellmod.load_cell("footbridge_n4096.epoch_clean")
    sl = TraceSlice(
        device=[("select_scan_kernel(x)", 10.0, 30.0), ("Memcpy HtoD", 30.0, 40.0),
                ("gemm", 50.0, 60.0)],
        host=[], requests=[("portbench.request", 0.0, 50.0), ("portbench.request", 50.0, 100.0)])
    run = loop.Run(config=cell.config, setup_s=1.0, window_s=2.0,
                   latencies_s=np.array([0.01, 0.02]), windows=np.array([2048, 2048]),
                   trace=sl)
    got = {m.name: m.reader.read(run) for m in cell.per_layer}
    assert got == {"idle_share.epoch": pytest.approx(100 * (1 - 40 / 100)),
                   "launches.epoch": 1.0}
    e2e = {m.name: m.reader.read(run) for m in cell.end_to_end}
    assert e2e["windows_per_s"] == 2048.0 and e2e["setup_s"] == 1.0
    assert e2e["epoch_p95_ms"] == pytest.approx(19.5)
    window = cellmod.load_cell("tunnel_n1024.window_noisy")
    run.trace = TraceSlice(device=[], host=[], requests=[])
    run.counters = [{"before": {"b1": 0, "lowlat": 0}, "after": {"b1": 0, "lowlat": 1}}] * 2
    assert {m.name: m.reader.read(run) for m in window.per_layer} == {
        "idle_share.window": None, "routed_share.window": 100.0,
        "lowlat_device_ms.window": None, "lowlat_roofline.window": None}


def test_routed_share_counts_out_the_request_that_left_the_route():
    cell = cellmod.load_cell("footbridge_n4096.window_noisy")
    # Request 0 stays on the route; 1 tries it and leaves (a B1 launch
    # besides); 2 skips it (no lowlat launch).
    counters = [{"before": {"b1": 0, "lowlat": 0}, "after": {"b1": 0, "lowlat": 1}},
                {"before": {"b1": 0, "lowlat": 1}, "after": {"b1": 1, "lowlat": 2}},
                {"before": {"b1": 1, "lowlat": 2}, "after": {"b1": 2, "lowlat": 2}}]
    sl = TraceSlice(
        device=[("lowlat_flexible_kernel", 1.0, 2.0), ("Memcpy DtoH", 2.0, 3.0),
                ("lowlat_flexible_kernel", 11.0, 12.0), ("select_scan_kernel", 13.0, 14.0),
                ("gemm", 15.0, 16.0), ("gemm", 21.0, 22.0), ("Memset", 23.0, 24.0)],
        host=[], requests=[("portbench.request", 0.0, 10.0), ("portbench.request", 10.0, 20.0),
                           ("portbench.request", 20.0, 30.0)])
    run = loop.Run(config=cell.config, setup_s=1.0, window_s=1.0,
                   latencies_s=np.array([0.001, 0.006, 0.008]), windows=np.ones(3, int),
                   trace=sl, counters=counters)
    got = {m.name: m.reader.read(run) for m in cell.per_layer}
    assert got["routed_share.window"] == pytest.approx(100 / 3)
    assert "lowlat_device_ms.window" not in got


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_exactly_its_keys(traced):
    c = small("footbridge_n4096.epoch_clean")
    result = loop.execute(c, 99, 0.0, traced, t0=time.perf_counter(), device="cpu",
                          requests=REQUESTS)
    assert result["attempted"] == REQUESTS
    line, lines = report.build(c, result, {"platform": "gpu", "kind": "x", "count": 1,
                                           "memory_peak_bytes": 1}, traced)
    assert list(line) == FIVE + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True
    assert set(line["checks"]) == set(c.limits)
    assert lines[-len(c.limits):] and all("limit" in ln for ln in lines[-len(c.limits):])
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


def _sleeps(x):
    """A planted request that sleeps 0.4 s."""
    time.sleep(0.4)
    return {"mag": np.zeros((len(x), 1), np.float32)}


def test_a_counted_window_runs_its_requests_whatever_the_clock():
    c = small(CELLS[0])
    result = loop.execute(c, 2**31 + 21, 0.3, False, t0=time.perf_counter(), call=_sleeps,
                          requests=REQUESTS)
    assert result["attempted"] == REQUESTS and result["failed"] == 0
    assert len(result["run"].latencies_s) == REQUESTS
    assert result["run"].window_s >= REQUESTS * 0.4


def test_without_a_count_the_clock_ends_the_window():
    """What a measured run does: the first request that ends past
    ``seconds`` closes the window (the second, at 0.8 s of 0.6)."""
    c = small(CELLS[0])
    result = loop.execute(c, 2**31 + 22, 0.6, False, t0=time.perf_counter(), call=_sleeps)
    assert result["attempted"] == 2
    assert result["run"].window_s >= 0.8


@pytest.mark.parametrize("name", CELLS)
def test_every_entry_returns_host_arrays_of_the_requests_rows(name):
    """The output contract of ``make_call`` (``harness/cell.py``) that the
    planted faults rely on."""
    c = small(name)
    w = int(c.traffic["windows_per_request"])
    pool = c.generator.make_pool(c.traffic["signal"], rows=int(c.traffic["pool_windows"]),
                                 n=c.config["n_fft"], fs=c.config["fs"], seed=2**31 + 23)
    out = c.entry.make_call(c.config, device="cpu")(pool[:w])
    assert isinstance(out, dict) and "mag" in out
    for field, v in out.items():
        assert isinstance(v, np.ndarray), (field, type(v))
        assert v.shape[:1] == (w,), (field, v.shape)


def _broken(c, fault: str):
    """The port's timed path with one fault planted underneath."""
    call = c.entry.make_call(c.config, device="cpu")
    state = {}

    def stale(x):
        out = call(x)
        prev, state["prev"] = state.get("prev"), out
        return prev if prev is not None else out

    def half(x):
        h = max(len(x) // 2, 1)
        out = call(x[:h])
        return {f: np.concatenate([v, v[: len(x) - h]]) for f, v in out.items()}

    def altered(x):
        out = call(x)
        out["mag"] = out["mag"].copy()
        out["mag"].flat[0] += 1.0
        return out

    return {"stale": stale, "half": half, "altered": altered}[fault]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in ("stale", "altered")]
                         + [(n, "half") for n in CELLS if "epoch" in n])
def test_a_broken_timed_path_is_not_correct(name, fault):
    c = small(name)
    result = loop.execute(c, 2**32 + 3, 0.0, False, t0=time.perf_counter(),
                          call=_broken(c, fault), requests=REQUESTS)
    assert result["attempted"] == REQUESTS
    line, _ = report.build(c, result, {}, False)
    assert line["correct"] is False, line["checks"]


def test_run_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                           "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _on_card(args):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"), *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
def test_one_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _on_card(["--workload", "tunnel_n1024.window_noisy", "--seed", str(2**32 + 5),
                     "--seconds", "2", "--trace", "0"])
    assert list(line) == FIVE + ["checks"] and line["correct"] is True
    assert set(line["metrics"]) == {"latency_p95_ms", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    """The port's precision="fast" (TF32) path in the program's place."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _on_card(["--workload", name, "--seed", str(2**32 + 9), "--seconds", "3",
                     "--trace", "0", "--control"])
    assert line["correct"] is False, line["checks"]
