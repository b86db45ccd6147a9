"""Where the port's CUDA sources build to (no ``nvcc`` needed).

A library's name carries a hash of its source, of every shared header in
``csrc/`` and of the compiler flags, so that an edit to any of them builds
a new library instead of loading a stale one.
"""

import os
import shutil

import pytest

from apda_fft_tpu_torch.utils import kernels


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, dst)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(dst))
    return dst


@pytest.mark.parametrize(
    "name", ["prominence_select_scan", "lowlat_window", "halfspec_fused", "prominence_scans"])
def test_library_name_follows_header_bytes(csrc_copy, name):
    before = kernels.library_path(name)
    assert before == kernels.library_path(name)
    header = csrc_copy / "detector_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert kernels.library_path(name) != before


def test_library_name_follows_source_and_new_headers(csrc_copy):
    before = kernels.library_path("lowlat_window")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    with_header = kernels.library_path("lowlat_window")
    assert with_header != before
    src = csrc_copy / "lowlat_window.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert kernels.library_path("lowlat_window") != with_header
    assert os.path.dirname(with_header) == kernels.BUILD_DIR
