"""The float64 reference against ``tests/oracle.py`` on the cells held to
it, and the port on the CPU against its reference in every cell, on small
seeded pools."""

from __future__ import annotations

import importlib.util
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import cell as cellmod  # noqa: E402
from portbench.harness import compare, loop  # noqa: E402
from portbench.reference import apda_float64  # noqa: E402
from portbench.tests.cpu_cells import REQUESTS, small  # noqa: E402

BENCH = cellmod.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: The cells held to ``apda_float64``; a configuration with another
#: reference brings its own test of it.
FLOAT64_CELLS = [n for n in CELLS if cellmod.load_cell(n).config["reference"]
                 == "portbench/reference/apda_float64.py"]


def _oracle():
    spec = importlib.util.spec_from_file_location(
        "portbench_test_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", FLOAT64_CELLS)
def test_reference_equals_the_oracle_window_for_window(name):
    c = small(name)
    cfg = c.config
    pool = c.generator.make_pool(c.traffic["signal"], rows=24, n=cfg["n_fft"], fs=cfg["fs"],
                             seed=2**33 + 7)
    got = apda_float64.analyze(pool, cfg["fs"], mode=cfg["mode"], k=cfg["k"],
                               refine=cfg["refine"])
    oracle = _oracle()
    for i, x in enumerate(pool):
        want = oracle.oracle_analyze(x.astype(np.float64), cfg["fs"], cfg["mode"])
        n = int(got["count"][i])
        assert n == len(want), (i, n, len(want))
        assert got["idx"][i, :n].tolist() == [p["idx"] for p in want]
        assert (got["idx"][i, n:] == -1).all()
        np.testing.assert_allclose(got["mag"][i, :n], [p["mag"] for p in want], rtol=1e-12)
        np.testing.assert_allclose(got["freq"][i, :n], [p["freq"] for p in want], rtol=1e-12)
        if cfg["mode"] == "flexible":
            assert got["damping"][i, :n].tolist() == [p["damping"] for p in want]
            assert got["q_factor"][i, :n].tolist() == [p["q-factor"] for p in want]
            np.testing.assert_allclose(got["prominence"][i, :n],
                                       [p["prominence"] for p in want], rtol=1e-10)


def test_reference_refine_is_the_parabolic_vertex():
    mags = np.array([[0.0, 1.0, 3.0, 2.0, 0.5, 0.0]])
    got = apda_float64.refine_subbin(mags, np.array([[2, -1]]), 0.5)
    delta = 0.5 * (1.0 - 2.0) / (1.0 - 6.0 + 2.0)
    np.testing.assert_allclose(got, [[(2 + delta) * 0.5, 0.0]])


@pytest.mark.parametrize("name", CELLS)
def test_port_on_the_cpu_passes_the_comparison(name):
    c = small(name)
    result = loop.execute(c, 2**33 + 11, 0.0, False, t0=time.perf_counter(), device="cpu",
                          requests=REQUESTS)
    check = loop.check(c, result)
    assert result["failed"] == 0 and result["attempted"] == REQUESTS
    assert check["numbers"]["windows_compared"] > 0
    assert check["ok"], check


def test_comparison_counts_a_decision_apart():
    c = small(CELLS[0])
    pool = c.generator.make_pool(c.traffic["signal"], rows=4, n=c.config["n_fft"],
                                 fs=c.config["fs"], seed=3)
    ref = compare.reference(c, pool)
    out = {f: ref[f].copy() for f in ref}
    out["n_required"] = np.zeros_like(out["count"])
    out["idx"][2, 0] += 1
    numbers = compare.readings(c, pool, 4, [(0, out)], ref)
    assert numbers["windows_apart"] == 1 and numbers["windows_compared"] == 4
    assert numbers["mag_gap"] == 0.0
