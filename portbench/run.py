#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with an NVIDIA card.  The
cell (``BENCHMARK.json`` ``workloads``) names a configuration and a traffic
mix; the run builds its pool of host inputs from ``--seed``, warms up,
then measures ``--seconds`` of requests through the configuration's entry
point (``portbench/entries/``; ``--trace 1``: a bounded slice under
``torch.profiler`` instead), compares what the window produced with the
plain reference, and prints one JSON line last:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}``.  The numbers compared, each beside its limit, are also the
last lines on standard error.

The kernels build into ``portbench/.cache/build`` inside the checkout, so
only a checkout's first run compiles (and says so on standard error); a
line on standard error splits the set-up into its steps.  It
exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when the process has loaded JAX or the JAX
package.  ``--control`` runs the port's ``precision="fast"`` path in the
program's place (the control of the comparison; never in a measured run).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE in sys.path:
    sys.path.remove(HERE)
sys.path.insert(0, ROOT)

#: Top-level module names that no run may load, compared whole (the port's
#: own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "apda_fft_tpu")
BUILD_DIR = os.path.join(ROOT, "portbench", ".cache", "build")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def one_run(cell, seed: int, seconds: float, trace: bool, *, t0: float, t_torch: float,
            precision: str | None = None) -> tuple[dict, list[str]]:
    """One run on the card: ``(result line, standard-error lines)``."""
    import torch

    from portbench.harness import loop, report

    torch.cuda.reset_peak_memory_stats()
    before = set(os.listdir(BUILD_DIR))
    result = loop.execute(cell, seed, seconds, trace, t0=t0, precision=precision,
                          sync=torch.cuda.synchronize, log=log)
    built = sorted(set(os.listdir(BUILD_DIR)) - before)
    if built:
        log(f"portbench: this run built {built} in its set-up "
            f"({result['run'].setup_s:.3f} s)")
    marks = {"torch": t_torch, **result["run"].setup_marks}
    log("portbench: set-up, seconds from the start at the end of each step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()))
    if trace:
        _cross_check(result["run"].trace, result["run"].counters)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }
    torch.cuda.empty_cache()
    return report.build(cell, result, device, trace)


def _cross_check(sl, counters) -> None:
    """The profiler's hand-kernel events against the port's own counters."""
    if not counters:
        return
    keys = ("b1", "b5", "b4", "lowlat")
    counted = sum(counters[-1]["after"][k] - counters[0]["before"][k] for k in keys)
    _, traced = sl.kernel_time_us("select_scan", "preselected_scans", "halfspec_fft",
                                  "lowlat_")
    if traced < counted:
        log(f"portbench: the profiler recorded {traced} of {counted} hand-kernel launches "
            f"({counted - traced} missing); the device-trace metrics read the recorded ones")
    else:
        log(f"portbench: profiler recorded all {counted} hand-kernel launches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from portbench.harness.cell import load_cell

    cell = load_cell(args.workload)
    import torch

    t_torch = time.perf_counter() - T0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    from apda_fft_tpu_torch.utils.compilecache import enable_compilation_cache

    enable_compilation_cache(BUILD_DIR, 0)
    out, lines = one_run(cell, args.seed, args.seconds, bool(args.trace), t0=T0,
                         t_torch=t_torch, precision="fast" if args.control else None)
    log(f"portbench: card {_power_limit()}; roofline peaks 3.35e12 B/s, 6.7e13 FLOP/s")
    found = forbidden_modules()
    if found:
        log(f"portbench: the run loaded {found}; no result")
        return 3
    for ln in lines:
        log(ln)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
