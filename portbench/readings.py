#!/usr/bin/env python3
"""Readings of the comparison for setting a cell's limits, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 101 102 ... \
        [--control-seeds 201 202 203] [--seconds 2] [--out FILE]

For each seed, one short run of the program as ``run.py`` makes it (the
dynamic budget reset before each, as in a fresh process), then for each
control seed one run of the control: the port's ``precision="fast"``
path in the program's place.  Prints one JSON line a run with every number
the comparison reads; ``--out`` appends the lines to a file too.  The
measured runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE in sys.path:
    sys.path.remove(HERE)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import run as bench_run
    from portbench.harness import loop
    from portbench.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    from apda_fft_tpu_torch.models import pipeline
    from apda_fft_tpu_torch.utils.compilecache import enable_compilation_cache

    enable_compilation_cache(bench_run.BUILD_DIR, 0)
    cell = load_cell(args.workload)
    # Every request is compared, so a run covers as many windows as it can.
    cell.traffic["keep_every"] = 1
    runs = [(s, None) for s in args.seeds] + [(s, "fast") for s in args.control_seeds]
    for seed, precision in runs:
        pipeline.reset_dynamic_state()
        t0 = time.perf_counter()
        result = loop.execute(cell, seed, args.seconds, False, t0=t0, precision=precision,
                              sync=torch.cuda.synchronize, log=bench_run.log)
        t1 = time.perf_counter()
        numbers = loop.check(cell, result)["numbers"]
        lat = np.asarray(result["run"].latencies_s) * 1e3
        line = {"workload": cell.name, "seed": seed,
                "latency_ms_p50_p90_p95_p99": np.percentile(lat, [50, 90, 95, 99]).tolist(),
                "side": "control" if precision else "program",
                "attempted": result["attempted"], "failed": result["failed"],
                "reference_s": time.perf_counter() - t1, **numbers,
                **{m.name: m.reader.read(result["run"]) for m in cell.end_to_end}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
