"""Readings of the correctness check's control: the plain reference in
fp8 (``reference/layers.fp8`` on every convolution's input and weight,
the precision below the configurations' bf16) put in the program's
place, on a cell's own inputs and sizes, compared with the fp32
reference by the cell's own numbers.  The benchmark's runs do not run it.

    python3 benchmark/tools/control.py --workload <name> --seeds 1,2,3 [--count 4]

One JSON line a seed.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark.harness import spec  # noqa: E402
from benchmark.reference.layers import fp8  # noqa: E402


def controlNumbers(cell, seed: int, count: int, device: str) -> dict:
    workdir = tempfile.mkdtemp(prefix="moephoto-control-")
    try:
        drv = cell.driver().Driver(cell, seed, device, workdir)
        entries = drv.controlEntries(count, fp8)
        return drv.check(entries)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fp8 control readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--count", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = controlNumbers(cell, seed, args.count, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
