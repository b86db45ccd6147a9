"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port or of the tests."""

from __future__ import annotations

import ast
import os

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "apda_fft_tpu"}
MODULES = sorted(
    os.path.relpath(os.path.join(d, f), PORTBENCH)
    for d, _, files in os.walk(PORTBENCH) if "__pycache__" not in d and ".cache" not in d
    for f in files if f.endswith(".py"))


def top_level_imports(path: str) -> set[str]:
    """The top-level names (the part before the first dot) of every
    import in the file, wherever it stands (functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_finds_every_part():
    for part in ("run.py", "harness/loop.py", "reference/apda_float64.py",
                 "metrics/idle_share.epoch.py", "entries/analyze_epoch.py",
                 "generators/sensor_windows.py"):
        assert part in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_no_jax_by_whole_top_level_name(module):
    names = top_level_imports(os.path.join(PORTBENCH, module))
    assert not names & FORBIDDEN, (module, names & FORBIDDEN)


def test_whole_names_tell_the_port_from_the_jax_package():
    names = top_level_imports(os.path.join(PORTBENCH, "entries", "analyze_epoch.py"))
    assert "apda_fft_tpu_torch" in names and not names & FORBIDDEN


@pytest.mark.parametrize("module", [m for m in MODULES if m.startswith("reference")])
def test_reference_imports_nothing_of_the_port_or_the_tests(module):
    names = top_level_imports(os.path.join(PORTBENCH, module))
    assert names <= {"__future__", "numpy"}, names
