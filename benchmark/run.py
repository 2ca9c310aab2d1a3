"""Run one cell of the port's benchmark on the card this process sees.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers of the correctness check beside their limits as the
last lines of standard error, and one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits
with another code than 0, and prints no result, without enough CUDA
cards, without the program beside the benchmark, or with JAX or the JAX
package loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PROGRAM = "moephoto_tpu_torch"


def cacheEnvironment():
    """Kernel caches in fixed directories of the checkout, so only a cell's
    first run there builds; no library loads JAX on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(BENCH, ".cache", sub)
    os.environ["USE_FLAX"] = "0"


def fail(code: int, message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return code


def powerLimit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cacheEnvironment()
    sys.path.insert(0, ROOT)
    from benchmark.harness import guard, spec

    faults = guard.sourceFaults()
    if faults:
        return fail(3, "forbidden imports in the benchmark: " + "; ".join(faults))
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.workload["chips"]):
        return fail(2, f"needs {cell.workload['chips']} CUDA card(s); "
                       f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import moephoto_tpu_torch
    except ImportError as e:
        return fail(2, f"the program ({PROGRAM}) is not beside the benchmark: {e}")
    if os.path.commonpath([os.path.abspath(moephoto_tpu_torch.__file__), ROOT]) != ROOT:
        return fail(2, f"{PROGRAM} was loaded from {moephoto_tpu_torch.__file__}, outside {ROOT}")

    from benchmark.harness.cell import readMetrics, runCell, verdict

    workdir = tempfile.mkdtemp(prefix="moephoto-bench-")  # weights as checkpoints, under TMPDIR
    try:
        run, peak, numbers = runCell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    bad = guard.loaded()
    if bad:
        return fail(3, "JAX or the JAX package was loaded: " + ", ".join(bad))

    correct, checks = verdict(cell, run.window, numbers)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell.workload["chips"]),
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.window.attempted, "failed": run.window.failed,
              "metrics": readMetrics(cell, run, bool(args.trace)), "device": device}
    if args.trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        device["power_limit_w"] = powerLimit()
        result["breakdown"] = run.trace.breakdown()
    result["diagnostics"] = run.diagnostics()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
