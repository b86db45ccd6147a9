"""The batched flexible pass's CUDA graphs (``models/graphs.py``) on the CPU.

No graph can be captured here, so the tests pretend a pass is on a card
(``graphs.eligible``) and stand in for the capture and the launch: the
stand-in "graph" runs the pass again on the inputs it is handed.  What is
held is the module's own: which passes may run from a graph, what a key
holds, the second sighting, the bound a device, the failure path, the
counters a replay advances, the device tables a graph reads and the packed
output.  A CPU epoch leaves the cache alone.  ``tests/test_torch_gpu_card.py``
holds real graphs on the card.
"""

import collections
import warnings

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from apda_fft_tpu_torch.models import graphs, pipeline
from apda_fft_tpu_torch.ops import detector_cuda, fft, fft_cuda, latency_cuda
from apda_fft_tpu_torch.utils import kernels

FS = 500.0
KW = dict(n_fft=64, mode="flexible", k=4, backend="matmul", max_candidates=8, refine=True,
          center="auto", batch_chunk=2048, taper="none", precision="highest")
Res = collections.namedtuple("Res", "count freq")


_COUNTERS = {detector_cuda: ("launches", "cluster_launches", "scan_launches",
                             "cluster_scan_launches"),
             fft_cuda: ("launches",)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    graphs.reset()
    monkeypatch.setattr(graphs, "passes", {"eager": 0, "captured": 0, "replayed": 0})
    # The launch counters read as before once a test is over.
    for mod, names in _COUNTERS.items():
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(latency_cuda, "launches", dict(latency_cuda.launches))
    saved = pipeline.dynamic_state()
    pipeline.reset_dynamic_state()
    yield
    graphs.reset()
    pipeline.load_dynamic_state(**saved)


class _OnDevice:
    """Stands in for samples on ``device`` for the eligibility rule."""

    def __init__(self, device: str, n: int = 8):
        self.device = torch.device(device)
        self._n = n

    def numel(self) -> int:
        return self._n


def _windows(b: int = 4, n: int = 64, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.sin(2 * np.pi * 60.0 * t) + 0.6 * np.sin(2 * np.pi * 170.0 * t)
    return torch.from_numpy((x + 0.05 * rng.standard_normal((b, n))).astype(np.float32))


def _args(b=4, n=64, dtype=torch.float32, fs_shape=(), lengths=None, corr=None,
          device="cpu"):
    samples = torch.zeros((b, n), dtype=dtype, device=device)
    fs = torch.full(fs_shape, FS, dtype=dtype, device=device)
    lens = None if lengths is None else torch.full(lengths, n, dtype=torch.int32)
    half = None if corr is None else torch.zeros(corr)
    return samples, fs, lens, half


@pytest.fixture
def fake_card(monkeypatch):
    """Every pass is eligible; a capture packs one eager run and keeps a
    stand-in graph that runs the pass again on what a replay hands it.  The
    capture notes one select+scan launch, as a pass of one B1 call would.
    Returns the captures made."""
    captures = []

    def capture(impl, args, kw):
        captures.append(args)
        res = impl(*args, **kw)
        packed, layout = graphs._pack(res)

        def graph(replay_args):
            return graphs._pack(impl(*replay_args, **kw))[0]

        return graphs._Graph(graph, args, packed, layout, type(res),
                             [("prominence_select_scan", 100, 0)], None)

    monkeypatch.setattr(graphs, "eligible", lambda samples, mode: mode == "flexible")
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_launch", lambda entry, args: entry.graph(args))
    return captures


def _fake_impl(calls):
    def impl(samples, fs, lengths, half_corr, **kw):
        calls.append(kw["max_candidates"])
        return Res(torch.arange(3, dtype=torch.int32), torch.ones(2))
    return impl


def _assert_bits_equal(got, want):
    assert type(got) is type(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("device, mode, n, want", [
    ("cuda:0", "flexible", 8, True),
    ("cuda:0", "rigid", 8, False),
    ("cuda:0", "adaptive", 8, False),
    ("cpu", "flexible", 8, False),
    ("cuda:0", "flexible", 0, False),
])
def test_only_flexible_passes_of_a_batch_on_a_card_are_eligible(device, mode, n, want):
    assert graphs.eligible(_OnDevice(device, n), mode) is want


def test_a_pass_under_a_dispatch_mode_stays_eager():
    """A flop counter sees each operation; a replay would hide them."""
    with FlopCounterMode(display=False):
        assert not graphs.eligible(_OnDevice("cuda:0"), "flexible")


def test_each_field_of_the_key_gives_its_own_entry():
    base = graphs.graph_key(*_args(), **KW)
    assert base == graphs.graph_key(*_args(), **KW)
    variants = [
        graphs.graph_key(*_args(device="meta"), **KW),
        graphs.graph_key(*_args(b=8), **KW),
        graphs.graph_key(*_args(n=128), **KW),
        graphs.graph_key(*_args(dtype=torch.float64), **KW),
        graphs.graph_key(*_args(fs_shape=(4,)), **KW),
        graphs.graph_key(*_args(lengths=(4,)), **KW),
        graphs.graph_key(*_args(corr=(4, 32)), **KW),
        graphs.graph_key(*_args(corr=(4, 16)), **KW),
    ]
    for field, value in (("n_fft", 128), ("mode", "rigid"), ("k", 5), ("backend", "xla"),
                         ("max_candidates", 16), ("max_candidates", (4, 16, 2)),
                         ("refine", False), ("center", "always"), ("batch_chunk", 0),
                         ("taper", "hann"), ("precision", "fast")):
        variants.append(graphs.graph_key(*_args(), **{**KW, field: value}))
    keys = [base, *variants]
    assert len(set(keys)) == len(keys)


def test_the_second_sighting_captures_and_later_passes_replay(fake_card):
    seen = []
    for seed in range(4):
        x = _windows(seed=seed)
        fs = torch.tensor(FS)
        got = graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW)
        _assert_bits_equal(got, pipeline._analyze_epoch_impl(x, fs, None, None, **KW))
        seen.append(dict(graphs.passes))
    assert seen == [{"eager": 1, "captured": 0, "replayed": 0},
                    {"eager": 1, "captured": 1, "replayed": 0},
                    {"eager": 1, "captured": 1, "replayed": 1},
                    {"eager": 1, "captured": 1, "replayed": 2}]
    assert len(fake_card) == 1


def test_a_key_seen_once_never_pays_for_a_capture(fake_card):
    calls = []
    for budget in (2, 4, 8, 16):
        graphs.run_pass(_fake_impl(calls), *_args(), **{**KW, "max_candidates": budget})
    assert calls == [2, 4, 8, 16] and fake_card == []
    assert graphs.passes == {"eager": 4, "captured": 0, "replayed": 0}


def _graphs_on(device: str) -> list:
    return [k for k, v in graphs._entries.items()
            if isinstance(v, graphs._Graph) and k[0] == torch.device(device)]


def test_each_device_keeps_its_least_recently_used_graphs_up_to_the_bound(fake_card):
    calls = []
    impl = _fake_impl(calls)
    budgets = range(1, graphs.MAX_GRAPHS + 2)
    for device in ("cpu", "meta"):
        for budget in budgets:
            for _ in range(2):  # the second sighting captures
                graphs.run_pass(impl, *_args(device=device), **{**KW, "max_candidates": budget})
    assert len(fake_card) == 2 * len(budgets)
    for device in ("cpu", "meta"):
        kept = [k[6] for k in _graphs_on(device)]
        assert kept == list(budgets)[1:]  # the first budget's graph was dropped
    # The dropped graph's key runs eagerly from now on: no capture again.
    for _ in range(2):
        graphs.run_pass(impl, *_args(), **{**KW, "max_candidates": 1})
    assert len(fake_card) == 2 * len(budgets)
    assert [k[6] for k in _graphs_on("cpu")] == list(budgets)[1:]


def test_keys_cycling_past_the_bound_are_captured_once_each(fake_card):
    """Traffic that cycles through more keys than a device keeps graphs
    (record buckets of many lengths) pays one capture a key in all; the
    keys whose graphs stay replay, the key whose graph was dropped runs
    eagerly."""
    impl = _fake_impl([])
    budgets = range(1, graphs.MAX_GRAPHS + 2)
    rounds = 6
    for _ in range(rounds):
        for budget in budgets:
            graphs.run_pass(impl, *_args(), **{**KW, "max_candidates": budget})
    assert len(fake_card) == len(budgets)
    assert graphs.passes == {
        "eager": len(budgets) + (rounds - 2),
        "captured": len(budgets),
        "replayed": graphs.MAX_GRAPHS * (rounds - 2)}
    assert [k[6] for k in _graphs_on("cpu")] == list(budgets)[1:]


def test_keys_without_a_graph_are_bounded(fake_card, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_KEYS", 8)
    impl = _fake_impl([])
    for budget in range(12):
        graphs.run_pass(impl, *_args(), **{**KW, "max_candidates": budget})
    assert [k[6] for k in graphs._entries] == list(range(4, 12))


def test_a_failed_capture_runs_eagerly_once_and_for_all(fake_card, monkeypatch):
    attempts = []

    def failing(impl, args, kw):
        attempts.append(1)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "_capture", failing)
    x, fs = _windows(), torch.tensor(FS)
    want = pipeline._analyze_epoch_impl(x, fs, None, None, **KW)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            _assert_bits_equal(
                graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW), want)
    assert len(attempts) == 1
    assert [w.category for w in caught] == [RuntimeWarning]
    assert graphs.passes == {"eager": 4, "captured": 0, "replayed": 0}
    assert list(graphs._entries.values()) == ["eager"]
    assert not graphs._capturing


def test_a_busy_graph_runs_the_pass_eagerly(fake_card):
    x, fs = _windows(), torch.tensor(FS)
    for _ in range(2):
        graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW)
    (entry,) = graphs._entries.values()
    with entry.lock:
        got = graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW)
    _assert_bits_equal(got, pipeline._analyze_epoch_impl(x, fs, None, None, **KW))
    assert graphs.passes == {"eager": 2, "captured": 1, "replayed": 0}
    graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW)
    assert graphs.passes["replayed"] == 1


def test_a_replay_adds_what_its_capture_counted(fake_card, monkeypatch):
    """Each replay, the capture pass's own included, notes the launches the
    capture noted, and the counters follow the notes (the eager pass ran
    the plain twin, which launches nothing)."""
    monkeypatch.setattr(detector_cuda, "launches", 0)
    noted = []
    x, fs = _windows(), torch.tensor(FS)
    with kernels.observe_launches(lambda *note: noted.append(note)):
        for _ in range(5):
            graphs.run_pass(pipeline._analyze_epoch_impl, x, fs, None, None, **KW)
    assert detector_cuda.launches == 4
    assert noted == [("prominence_select_scan", 100, 0)] * 4


@pytest.mark.parametrize("name, grew", [
    ("prominence_select_scan", {"detector_cuda.launches": 1}),
    ("prominence_select_scan_cluster",
     {"detector_cuda.launches": 1, "detector_cuda.cluster_launches": 1}),
    ("prominence_scans", {"detector_cuda.scan_launches": 1}),
    ("prominence_scans_cluster",
     {"detector_cuda.scan_launches": 1, "detector_cuda.cluster_scan_launches": 1}),
    ("halfspec_fused", {"fft_cuda.launches": 1}),
    ("lowlat_rigid_cluster", {"lowlat_rigid_cluster": 1}),
    ("some_other_kernel", {}),
])
def test_the_launch_counters_follow_the_noted_launches(name, grew):
    def counters():
        out = {f"{mod.__name__.rsplit('.', 1)[1]}.{attr}": getattr(mod, attr)
               for mod, attrs in _COUNTERS.items() for attr in attrs}
        return {**out, **latency_cuda.launches}

    before = counters()
    kernels.note_launch(name, 1, 0)
    after = counters()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == grew
    with kernels.withheld() as held:
        kernels.note_launch(name, 1, 0)
    assert counters() == after and held == [(name, 1, 0)]


def test_withheld_launches_reach_no_observer():
    noted = []
    with kernels.observe_launches(lambda *note: noted.append(note)):
        with kernels.withheld() as held:
            kernels.note_launch("prominence_select_scan", 1, 0)
        kernels.note_launch("halfspec_fused", 2, 3)
    assert held == [("prominence_select_scan", 1, 0)]
    assert noted == [("halfspec_fused", 2, 3)]


def test_the_packed_output_unpacks_to_the_same_bits():
    x, fs = _windows(b=6), torch.tensor(FS)
    res = pipeline._analyze_epoch_impl(x, fs, None, None, **KW)
    packed, layout = graphs._pack(res)
    assert packed.dtype == torch.uint8
    assert packed.numel() == sum(f.numel() * f.element_size() for f in res)
    entry = graphs._Graph(None, (), packed, layout, type(res), [], None)
    _assert_bits_equal(entry.result(packed.clone()), res)


@pytest.mark.parametrize("cache", [fft._direct_tables, fft._fourstep_tables,
                                   fft._packed_tables, fft_cuda._twiddle_table],
                         ids=lambda f: f.__name__)
def test_the_device_tables_a_graph_reads_are_never_dropped(cache):
    """A graph reads these tables where it was captured: an entry that a
    cache dropped would free memory that later replays still read."""
    assert cache.cache_info().maxsize is None


def test_a_table_outlives_many_other_entries():
    first = fft._fourstep_tables(4096, 64, torch.float32, torch.device("cpu"))
    for n_out in range(65, 65 + 80):  # more entries than any bound the cache had
        fft._fourstep_tables(4096, n_out, torch.float32, torch.device("cpu"))
    again = fft._fourstep_tables(4096, 64, torch.float32, torch.device("cpu"))
    assert all(a is b for a, b in zip(again, first))


def test_a_cpu_epoch_leaves_the_graphs_alone():
    x = _windows(b=8).numpy()
    want = pipeline._analyze_epoch_impl(torch.from_numpy(x), torch.tensor(FS), None, None,
                                        **{**KW, "max_candidates": 2})
    for _ in range(3):
        got = pipeline.analyze_epoch(x, FS, n_fft=64, mode="flexible", refine=True,
                                     max_candidates=2, device="cpu")
        _assert_bits_equal(got, want)
    assert graphs.passes == {"eager": 0, "captured": 0, "replayed": 0}
    assert not graphs._entries


@pytest.mark.parametrize("mode", ["flexible", "adaptive", "rigid"])
def test_the_pipeline_runs_each_flexible_pass_through_the_graphs(fake_card, mode):
    """Dynamic epochs as a card would run them: the flexible passes (also
    adaptive mode's prominence pass) are captured and replayed, rigid ones
    run eagerly; the results are the eager epoch's."""
    xs = [_windows(b=8, seed=s).numpy() for s in range(4)]
    want = [pipeline.analyze_epoch(x, FS, mode=mode, refine=True, device="cpu") for x in xs]
    graphs.reset()
    graphs.passes.update(eager=0, captured=0, replayed=0)
    pipeline.reset_dynamic_state()
    for x, w in zip(xs, want):
        _assert_bits_equal(pipeline.analyze_epoch(x, FS, mode=mode, refine=True, device="cpu"), w)
    if mode == "rigid":
        assert graphs.passes == {"eager": 0, "captured": 0, "replayed": 0}
    else:
        assert graphs.passes["captured"] == 1 and graphs.passes["replayed"] >= 2
