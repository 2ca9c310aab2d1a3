"""Run a cell several times, one process after another, and keep every
result line: the way to measure a cell's spread and its readings.

    python3 benchmark/tools/series.py --workload <name> --seeds 1,2,3 --seconds 30 [--trace 0] --out runs.jsonl

Each line of ``--out`` is the run's result line with ``workload``,
``seed``, ``trace``, ``rc``, ``wall_s`` and the end of its standard error
added.  ``--summary`` prints each metric's median and spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median) of a file.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runOnce(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=os.path.dirname(BENCH))
    lines = proc.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1]) if lines else {}
    except ValueError:
        out = {}
    out.update(workload=workload, seed=seed, trace=trace, rc=proc.returncode,
               wall_s=time.perf_counter() - t0, stderr=proc.stderr[-3000:])
    return out


def summary(path: str):
    rows = [json.loads(l) for l in open(path) if l.strip()]
    by = {}
    for r in rows:
        for name, m in r.get("metrics", {}).items():
            by.setdefault((r["workload"], r["trace"], name), []).append(m["value"])
    for (wl, tr, name), vals in sorted(by.items()):
        med = statistics.median(vals)
        spread = None
        if len(vals) >= 2:
            q1, _, q3 = statistics.quantiles(vals, n=4)
            spread = (q3 - q1) / med if med else None
        print(json.dumps({"workload": wl, "trace": tr, "metric": name, "n": len(vals), "median": med,
                          "spread": spread, "min": min(vals), "max": max(vals)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="several runs of one cell")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--summary")
    args = ap.parse_args(argv)
    if args.summary:
        summary(args.summary)
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        r = runOnce(args.workload, seed, args.seconds, args.trace)
        with open(args.out, "a") as fp:
            fp.write(json.dumps(r) + "\n")
        short = {k: r.get(k) for k in ("workload", "seed", "trace", "rc", "wall_s", "correct", "attempted", "failed")}
        short["metrics"] = {k: v["value"] for k, v in r.get("metrics", {}).items()}
        short["checks"] = {k: v["value"] for k, v in r.get("checks", {}).items()}
        print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
