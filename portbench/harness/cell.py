"""A cell of ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each part is a file found by name:

* ``portbench/configs/<config>.json``: the deployment (mode, rate, window
  length, k, refine, the library's options), its reference's file and its
  ``"entry"``;
* ``portbench/entries/<entry>.py``: the entry point a request goes
  through, with ``make_call``, ``counters`` and ``check`` (the comparison
  with the reference).  ``make_call(config, device=, precision=)``
  returns the timed call: it takes one request's host rows (an array
  whose first axis is the request's rows) and returns a dict of host
  NumPy arrays, the first axis of each being those rows, with ``"mag"``
  among the keys.  The tests plant their faults on that contract (a
  stale result, half the rows, an altered ``mag``).  On the CPU a request
  may take any time: the tests count requests, not seconds;
* ``portbench/traffic/<traffic>.json``: the parameters of the request
  loop (``loop.py``) and of the ``"generator"`` it names;
* ``portbench/generators/<generator>.py``: ``make_pool``, the seeded pool
  of host inputs;
* ``portbench/limits/<workload>.json``: the limit of each number the
  comparison reads in this cell;
* ``portbench/metrics/<metric>.py``: one reader a metric, end to end or
  per layer, listed for the cell in ``BENCHMARK.json``.

So a new cell, metric, entry point or signal model is new files and
entries, never an edit.

A configuration names its reference (``"reference"``).  The tests hold
``portbench/reference/apda_float64.py`` against ``tests/oracle.py`` on the
cells that use it alone; a configuration with another reference brings
its own test of that reference in the change that adds it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object  # a module with ``read(run) -> float | None``


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    entry: object  # portbench/entries/<entry>.py
    generator: object  # portbench/generators/<generator>.py


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _module(folder: str, name: str, needs: tuple[str, ...], root: str = ROOT):
    """The module ``portbench/<folder>/<name>.py`` (a name may hold dots),
    which has to define each of ``needs``."""
    path = os.path.join(root, "portbench", folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [n for n in needs if not callable(getattr(module, n, None))]
    if missing:
        raise TypeError(f"{path} lacks {missing}")
    return module


def metric_reader(name: str, root: str = ROOT):
    """The module ``portbench/metrics/<name>.py``, with ``read(run)``."""
    return _module("metrics", name, ("read",), root)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    readers of the metrics it reports; raises ``KeyError`` for a name that
    ``BENCHMARK.json`` does not list."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(root, "portbench", "limits", f"{name}.json"))

    def metrics(kind: str) -> list[Metric]:
        return [Metric(m["name"], m["unit"], metric_reader(m["name"], root))
                for m in bench[kind] if _applies(m, name)]

    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"),
                entry=_module("entries", config["entry"], ("make_call", "counters", "check"),
                              root),
                generator=_module("generators", traffic["generator"], ("make_pool",), root))
