"""The port's profiling helpers and build cache, on the CPU.

``utils/profiling.py``'s ``trace`` writes a trace file and
``compiled_stats`` counts a product's operations (``tests/test_observability.py``'s
case); the kernels' work counts reach ``compiled_stats`` through the
wrappers' launch notes; ``utils/compilecache.py`` points the kernel builder
and the native ingest's builder at a cache directory and back.
"""

import os

import torch

from apda_fft_tpu_torch.io import native
from apda_fft_tpu_torch.ops import detector_cuda, fft_cuda, latency_cuda
from apda_fft_tpu_torch.utils import compilecache, kernels, profiling


def test_trace_writes_a_file(tmp_path):
    x = torch.ones((64, 64))
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::mm" in (tmp_path / "trace" / files[0]).read_text()


def test_compiled_stats_counts_a_product():
    x = torch.ones((64, 64), dtype=torch.float32)
    stats = profiling.compiled_stats(lambda a: a @ a, x)
    assert set(stats) == {"flops", "bytes_accessed", "memory_mb"}
    assert stats["flops"] == 2 * 64**3
    assert stats["bytes_accessed"] == -1.0  # no kernel launched
    assert stats["memory_mb"] == -1.0  # no card


def test_compiled_stats_adds_the_kernels_work(monkeypatch):
    """A kernel launch's work (as its wrapper notes it) joins the count."""
    def fake_epoch(x):
        kernels.note_launch("prominence_select_scan", *detector_cuda.select_scan_work(8, 2048, 12))
        kernels.note_launch("halfspec_fused", *fft_cuda.halfspec_work(8, 4096))
        kernels.note_launch("lowlat_flexible", *latency_cuda.lowlat_work(4096, 4))
        return x @ x

    x = torch.ones((4, 4))
    stats = profiling.compiled_stats(fake_epoch, x)
    b1, b4, b2 = (detector_cuda.select_scan_work(8, 2048, 12), fft_cuda.halfspec_work(8, 4096),
                  latency_cuda.lowlat_work(4096, 4))
    assert stats["flops"] == 2 * 4**3 + b4[1] + b2[1]
    assert stats["bytes_accessed"] == b1[0] + b4[0] + b2[0]
    assert b4 == (8 * 4096 * 6, 8 * (int(2.5 * 4096 * 12) + 4 * 2048))
    assert kernels._observers == []


def test_compile_cache_redirects_the_builders_and_restores_them(tmp_path):
    before = (kernels.BUILD_DIR, native._BUILD_DIR, kernels.library_path("halfspec_fused"),
              native._library_path())
    assert compilecache.enabled_dir() is None
    try:
        d = compilecache.enable_compilation_cache(str(tmp_path / "cache"))
        assert d == str(tmp_path / "cache") and os.path.isdir(d)
        assert compilecache.enable_compilation_cache(str(tmp_path / "elsewhere")) == d
        assert compilecache.enabled_dir() == d
        assert kernels.library_path("halfspec_fused") == os.path.join(
            d, os.path.basename(before[2]))
        assert native._library_path() == os.path.join(d, os.path.basename(before[3]))
        assert kernels.MIN_PERSIST_SECS == native.MIN_PERSIST_SECS == 1.0
    finally:
        compilecache.disable_compilation_cache()
    assert compilecache.enabled_dir() is None
    assert (kernels.BUILD_DIR, native._BUILD_DIR, kernels.library_path("halfspec_fused"),
            native._library_path()) == before
    assert kernels.MIN_PERSIST_SECS == native.MIN_PERSIST_SECS == 0.0


def test_a_quick_build_is_not_kept_in_the_cache(tmp_path, monkeypatch):
    """Below ``min_compile_time_secs`` a library is loaded, then removed
    from the cache directory (it rebuilds faster than a cache is worth)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.delenv("APDA_NO_NATIVE", raising=False)
    try:
        d = compilecache.enable_compilation_cache(str(tmp_path / "cache"),
                                                  min_compile_time_secs=3600.0)
        assert native.load() is not None
        assert os.listdir(d) == []
        compilecache.disable_compilation_cache()
        monkeypatch.setattr(native, "_lib", None)
        d = compilecache.enable_compilation_cache(str(tmp_path / "kept"),
                                                  min_compile_time_secs=0.0)
        assert native.load() is not None
        assert os.listdir(d) == [os.path.basename(native._library_path())]
    finally:
        compilecache.disable_compilation_cache()
