#!/usr/bin/env python3
"""Repeated runs of one cell, each a fresh process, and their spreads.

    python3 portbench/spread.py --workload <cell> --seconds <s> --seeds 1 2 3 4 5 6 \
        [--trace 0|1] [--out FILE]

Runs ``run.py`` once a seed, in turn, and prints each run's last line, then
for each metric its median and its spread: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of
the median.  ``--out`` appends every line to a file.  This is how a cell's
bounds are set; the measured runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", nargs="+", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
             "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True)
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            line = json.loads(last)
        except json.JSONDecodeError:
            line = {"correct": None, "rc": proc.returncode, "stderr": proc.stderr[-2000:]}
        line.update(workload=args.workload, seed=seed, rc=proc.returncode,
                    stderr_tail=proc.stderr.strip().splitlines()[-8:])
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    names = sorted({n for ln in lines for n in ln.get("metrics", {})})
    summary = {}
    for n in names:
        vals = [ln["metrics"][n]["value"] for ln in lines if n in ln.get("metrics", {})]
        if len(vals) >= 2:
            summary[n] = {"median": statistics.median(vals), "spread": spread(vals),
                          "values": vals}
    out = {"workload": args.workload, "summary": summary,
           "correct": [ln.get("correct") for ln in lines]}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0 if all(ln.get("correct") for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
