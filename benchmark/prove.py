"""Run a cell's proof on the card and summarise it: sets of untraced runs
on the same seeds, traced runs on others, one process at a time, and the
spread of each end-to-end metric.

    python benchmark/prove.py --workload cifar10_4k.train --seconds 20 \\
        --seeds 11,12,13,14,15,16 --sets 2 --traced 21,22,23 --out proof_runs

Each run's standard output and error go to ``--out``. The summary gives,
for each metric and set, the median and the spread (Q3 − Q1) / median as
``statistics.quantiles(values, n=4)`` gives the quartiles, the wider of
the sets' spreads, and five times it, the bound that spread suggests.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def one(workload: str, seed: int, seconds: float, trace: int, out: str) -> dict:
    stem = os.path.join(out, f"{workload}.{seed}.{trace}")
    t = time.perf_counter()
    with open(stem + ".out", "w") as so, open(stem + ".err", "w") as se:
        rc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed",
                             str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                            stdout=so, stderr=se, cwd=ROOT).returncode
    wall = time.perf_counter() - t
    line = None
    if rc == 0:
        with open(stem + ".out") as f:
            line = json.loads(f.read().strip().splitlines()[-1])
    row = {"seed": seed, "trace": trace, "rc": rc, "wall_s": wall, "line": line}
    print(json.dumps({k: v for k, v in row.items() if k != "line"} | (
        {"correct": line["correct"], "metrics": {k: v["value"] for k, v in line["metrics"].items()},
         "checks": {k: v["value"] for k, v in line["checks"].items()},
         "device": line["device"]} if line else {})), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    sets = [[one(args.workload, s, args.seconds, 0, args.out) for s in seeds] for _ in range(args.sets)]
    traced = [one(args.workload, int(s), args.seconds, 1, args.out) for s in args.traced.split(",") if s]
    summary = {"workload": args.workload, "runs": sum(map(len, sets)) + len(traced),
               "correct": sum(bool(r["line"] and r["line"]["correct"]) for r in sum(sets, []) + traced)}
    if seeds and all(r["line"] for r in sum(sets, [])):
        for name in sets[0][0]["line"]["metrics"]:
            per = []
            for runs in sets:
                vals = [r["line"]["metrics"][name]["value"] for r in runs]
                per.append({"median": statistics.median(vals), "spread": spread(vals) if len(vals) >= 2 else None,
                            "values": vals})
            widest = max(p["spread"] for p in per if p["spread"] is not None) if len(seeds) >= 2 else None
            summary[name] = {"sets": per, "widest_spread": widest,
                             "bound_5x": None if widest is None else 5 * widest}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
