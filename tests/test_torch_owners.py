"""Each decision that several of the port's modules share has one owner.

A scan of the port's sources (``apda_fft_tpu_torch/``):

- Only ``models/budget.py`` names the dynamic budget's tables, and the
  budget's growth formula ``min(max(pow2(n_req), hwm, FLOOR), limit)`` is
  written once, so the route, the batched loop and the stream cannot drift
  apart on the rule that keeps a served window exact.
- No module below the pipeline (``ops/``, ``utils/``,
  ``parallel/distributed_fft.py``) imports ``models.pipeline``; the one
  exception is ``ops/latency_cuda.py``, which takes ``default_k`` and
  ``refine_subbin`` from it (the JAX package places them there too).
"""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "apda_fft_tpu_torch")

OWNER = "models/budget.py"
TABLES = {"_dynamic_budget", "_dynamic_budget_hwm", "_dynamic_tier"}
#: Modules below the pipeline that still import from it, and the names they take.
UPWARD = {"ops/latency_cuda.py": {"default_k", "refine_subbin"}}
PIPELINE = "apda_fft_tpu_torch.models.pipeline"


def _sources() -> dict[str, ast.Module]:
    out = {}
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    out[os.path.relpath(path, PORT)] = ast.parse(fh.read())
    return out


def _identifiers(tree: ast.Module) -> set[str]:
    """Every name a module binds, reads or imports, and every attribute it
    reads, plus string constants (a ``getattr`` by name)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.alias):
            names.update(n for n in (node.name, node.asname) if n)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
    return names


def _pipeline_imports(tree: ast.Module) -> set[str]:
    """What a module imports from ``models.pipeline``, at any depth (a lazy
    import inside a function counts); the module itself counts as ``*``."""
    taken = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == PIPELINE:
                taken.update(a.name for a in node.names)
            elif node.module == "apda_fft_tpu_torch.models":
                taken.update("*" for a in node.names if a.name == "pipeline")
        elif isinstance(node, ast.Import):
            taken.update("*" for a in node.names if a.name == PIPELINE)
    return taken


def test_only_the_owner_names_the_budget_tables():
    sources = _sources()
    assert TABLES <= _identifiers(sources[OWNER])
    naming = {rel: sorted(TABLES & _identifiers(tree))
              for rel, tree in sources.items() if rel != OWNER}
    assert {rel: names for rel, names in naming.items() if names} == {}


def test_the_growth_formula_is_written_once():
    """``max(...)`` over a power of two and the high-water table: one in the
    whole port."""
    growth = []
    for rel, tree in _sources().items():
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "max"):
                inside = _identifiers(ast.Module(body=[ast.Expr(a) for a in node.args],
                                                 type_ignores=[]))
                if "_pow2_at_least" in inside and "_dynamic_budget_hwm" in inside:
                    growth.append((rel, node.lineno))
    assert len(growth) == 1 and growth[0][0] == OWNER, growth


def test_no_module_below_the_pipeline_imports_it():
    below = {rel: _pipeline_imports(tree) for rel, tree in _sources().items()
             if rel.startswith(("ops/", "utils/")) or rel == "parallel/distributed_fft.py"}
    assert set(UPWARD) <= set(below)
    assert {rel: taken for rel, taken in below.items() if taken} == UPWARD
