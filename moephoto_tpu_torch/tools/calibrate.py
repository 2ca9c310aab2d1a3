"""TileSpec calibration: the counterpart of the JAX package's
``tools/calibrate.py`` (the analog of the reference's memory calibration,
``test/memTest.py`` and ``test/memModule.py``, which produced its
per-model ``ramCoef`` tables).

For a registry model, sweeps (tile, batch) candidates on one seeded image,
prints each point's throughput and peak device memory, and the best
point.  Runs on the configured device (the card unless the config asks for
the CPU):

    python -m moephoto_tpu_torch.tools.calibrate lite4 [--tiles 192,256,384] \\
        [--batches 2,4,8,16] [--size 1080x1920]

Each point is a fresh ``ModelExec`` over the registry exec's model with the
entry's spec at that tile and batch: one warm call, then the mean of three
calls that end in a device synchronise.  The peak memory
(``torch.cuda.max_memory_allocated`` since a reset before the warm call,
less what was allocated before it: the point's own tiles, activations and
output) is the card's counterpart of the JAX tool's "compiles within
HBM".  A point that runs out of device memory prints ``FAILED``; any other
error stops the sweep.  Nothing here changes a registry spec.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch


def measure(ex, x, device: torch.device) -> tuple:
    """(seconds a call, peak device MiB above what was allocated before the
    point, or None on the CPU) of ``ex(x)``."""
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    if cuda:
        resident = torch.cuda.memory_allocated(device)  # the model, the image and whatever the caller holds
        torch.cuda.reset_peak_memory_stats(device)
    ex(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        ex(x)
    sync()
    dt = (time.perf_counter() - t0) / 3
    return dt, ((torch.cuda.max_memory_allocated(device) - resident) / 2**20 if cuda else None)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("--tiles", default="192,256,384")
    ap.add_argument("--batches", default="2,4,8,16")
    ap.add_argument("--size", default="1080x1920")
    args = ap.parse_args(argv)

    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.tools.export import lookup
    from moephoto_tpu_torch.pipeline import registry

    entry = lookup(args.model)
    H, W = (int(t) for t in args.size.split("x"))
    base = registry.buildExec(entry)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(H, W, 3).astype(np.float32)).to(base.device)
    where = torch.cuda.get_device_name(base.device) if base.device.type == "cuda" else "cpu"
    print(f"calibrating {args.model} at {H}x{W} on {base.device} ({where}), {base.dtype}")
    results = []
    for tile in (int(t) for t in args.tiles.split(",")):
        for batch in (int(b) for b in args.batches.split(",")):
            spec = replace(entry["spec"], tile=tile, batch=batch)
            ex = ModelExec(base.model, spec, channelSplit=base.channelSplit, outC=base.outC,
                           prepare=base.prepare, dtype=base.dtype, device=base.device)
            try:
                dt, peak = measure(ex, x, base.device)
            except torch.cuda.OutOfMemoryError as e:
                msg = str(e).splitlines()[0][:100]
                print(f"tile={tile} batch={batch}: FAILED ({msg})")
                torch.cuda.empty_cache()
                continue
            mpxs = H * W / 1e6 / dt
            results.append({"tile": tile, "batch": batch, "mpx_per_s": mpxs, "peak_mib": peak})
            mem = f", peak {peak:.0f} MiB" if peak is not None else ""
            print(f"tile={tile} batch={batch}: {mpxs:.2f} Mpx/s{mem}")
    if results:
        best = max(results, key=lambda r: r["mpx_per_s"])
        print(f"\nbest: tile={best['tile']} batch={best['batch']} -> {best['mpx_per_s']:.2f} Mpx/s")
    return results


if __name__ == "__main__":
    main()
