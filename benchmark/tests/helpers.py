"""Cells at a size a CPU test run can hold: each cell's own
configuration and limits, with a small traffic mix of its kind."""

import dataclasses
import time

from benchmark.harness import spec
from benchmark.harness.cell import runCell, verdict

TINY = {
    "images": {"kind": "images", "pool": 3, "sizes": [[64, 48]], "sample": 2},
    "mixed": {"kind": "images", "pool": 4, "long_side": [40, 88, 8], "aspects": [[1, 1], [16, 9]], "portrait": 0.5,
              "shape_seed": 3, "sample": 2},
    "clip": {"kind": "clip", "width": 64, "height": 40, "frames": 6, "max_speed": 2, "warm_frames": 20, "sample": 2},
}
KIND = {"sr_lite4_1080p": "images", "sr_lite4_small_mixed": "mixed", "slomo_ifrnet_m_1080p": "clip"}


def tinyCell(name: str):
    return dataclasses.replace(spec.cell(name), traffic=dict(TINY[KIND[name]]))


def runTiny(name: str, tmp_path, seed: int = 2**31 + 7, seconds: float = 0.5, traced: bool = False):
    """-> (correct, checks, run) of a short run of the cell on the CPU."""
    cell = tinyCell(name)
    run, _, numbers = runCell(cell, seed, seconds, traced, "cpu", time.perf_counter(), str(tmp_path))
    ok, checks = verdict(cell, run.window, numbers)
    return ok, checks, run
