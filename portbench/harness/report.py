"""The result line of a run, and the compared numbers beside their limits.

The last line of a run's standard output is one JSON object with the keys
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
traced run's ``breakdown``, and last ``checks``: each number the
comparison holds to a limit, with its value and its limit.  The same
numbers are the last lines on standard error.
"""

from __future__ import annotations

from portbench.harness import loop
from portbench.harness import trace as tracing


def _value(x):
    return int(x) if isinstance(x, (bool, int)) else float(x)


def metrics(cell, run, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced) that their readers find something to read for."""
    out = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = m.reader.read(run)
        if v is not None:
            out[m.name] = {"value": _value(v), "unit": m.unit}
    return out


def build(cell, result: dict, device: dict, traced: bool) -> tuple[dict, list[str]]:
    """``(result line, standard-error lines)`` of a finished run; runs the
    comparison with the reference."""
    run = result["run"]
    line = {"metrics": metrics(cell, run, traced)}
    if traced:
        device = {**device, "busy_s": run.trace.busy_us() / 1e6,
                  "window_s": run.trace.wall_us / 1e6}
        line["breakdown"] = tracing.breakdown(run.trace)
    run.trace = None
    check = loop.check(cell, result)
    numbers, limits = check["numbers"], check["limits"]
    info = [f"portbench: {n} {numbers[n]!r} (not compared)"
            for n in numbers if n not in limits]
    lines = info + [f"portbench: {n} {numbers[n]!r} limit {limits[n]!r} "
                    f"{'ok' if numbers[n] <= limits[n] else 'FAILS'}" for n in limits]
    correct = bool(check["ok"] and result["failed"] == 0 and result["attempted"] > 0)
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": line["metrics"], "device": device}
    if traced:
        out["breakdown"] = line["breakdown"]
    out["checks"] = {n: {"value": _value(numbers[n]), "limit": limits[n]} for n in limits}
    return out, lines
