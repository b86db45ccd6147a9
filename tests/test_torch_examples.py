"""The port's example scripts against the JAX package's, on the CPU.

Each of ``apda_fft_tpu_torch/examples/*.py`` runs with ``--device cpu`` in
this process, and its counterpart in ``examples/`` (the JAX package's, on
the CPU the root ``conftest.py`` pins) runs beside it; what the two print
must match line by line under ``tests/example_lines.py``'s rule: times,
dates and temp paths masked, numbers within one step of their printed
precision plus 2e-5 relative, SSI's lines within 1e-2 relative.
"""

import runpy
import sys
from pathlib import Path

import pytest

from tests import example_lines

ROOT = Path(__file__).parent.parent
NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))


def _run(path: Path, argv: list[str], capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


def test_every_jax_example_has_a_port():
    ported = sorted(p.stem for p in (ROOT / "apda_fft_tpu_torch" / "examples").glob("*.py"))
    assert NAMES and [n for n in ported if n != "__init__"] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_the_jax_script_prints(name, capsys, monkeypatch):
    got = _run(ROOT / "apda_fft_tpu_torch" / "examples" / f"{name}.py", ["--device", "cpu"],
               capsys, monkeypatch)
    want = _run(ROOT / "examples" / f"{name}.py", [], capsys, monkeypatch)
    assert got.strip()
    assert example_lines.mismatches(got, want) == []
