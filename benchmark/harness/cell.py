"""One run of one cell: set-up, the measured window, the metrics, and the
check of the window's outputs against the plain reference.

A driver (``benchmark/drivers/<entry>.py``) provides ``Driver(cell,
seed, device, workdir)`` with ``run(seconds) -> Window``,
``countWork(window)`` (the reference's work counts of each item, for the
per-layer metrics), ``release()`` and ``check() -> {number: value}``;
its constructor builds and warms everything the window uses.  The window is a closed loop that ends on
the first completion at or after ``seconds``, so its length holds whole
requests.
"""

from __future__ import annotations

import math
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.harness import trace as tracing


@dataclass
class Item:
    """One completed request (an image) or output (a video frame)."""

    t0: float
    t1: float
    inPx: int = 0
    outPx: int = 0
    flops: float = 0.0
    k1: float = 0.0  # K1's least seconds for this item's work
    k2: float = 0.0  # K2's least seconds for this item's work
    ok: bool = True
    shape: tuple = ()  # the input's (height, width)
    interpolated: bool = False  # a video frame the model made


@dataclass
class Window:
    t0: float
    t1: float
    items: List[Item] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def done(self) -> List[Item]:
        return [i for i in self.items if i.ok]


@dataclass
class Run:
    setup_s: float
    window: Window
    trace: Optional[tracing.Trace] = None
    load: tuple = ()  # the host's 1-minute load average at the window's start and end
    phases: dict = field(default_factory=dict)  # seconds from the run's start at each step of set-up

    def diagnostics(self) -> dict:
        """What helps to explain a run that reads far off: the host's load
        and the quartiles of the items' times."""
        times = [i.t1 - i.t0 for i in self.window.items]
        q = statistics.quantiles(times, n=4) if len(times) >= 2 else times
        return {"load_avg_1min": list(self.load), "item_s_quartiles": q, "items": len(times),
                "setup_phases_s": self.phases}


class Sample:
    """A seeded uniform sample of ``k`` of the window's outputs (reservoir
    sampling: one draw per output, no copy), plus the largest output."""

    def __init__(self, k: int, seed: int):
        import numpy as np

        self.k, self.rng = int(k), np.random.default_rng(int(seed))
        self.kept: List[tuple] = []
        self.largest: Optional[tuple] = None
        self.seen = 0

    def offer(self, size: int, entry: tuple):
        if self.largest is None or size > self.largest[0]:
            self.largest = (size, entry)
        if len(self.kept) < self.k:
            self.kept.append(entry)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.kept[j] = entry
        self.seen += 1

    def entries(self) -> List[tuple]:
        out = list(self.kept)
        if self.largest is not None and not any(e is self.largest[1] for e in out):
            out.append(self.largest[1])
        return out


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def runCell(cell, seed: int, seconds: float, traced: bool, device, t0: float, workdir: str):
    """-> (Run, memory peak bytes, {number: value} of the check)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    tImport = time.perf_counter()
    drv = cell.driver().Driver(cell, seed, device, workdir)
    if cuda:
        torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    trace, load0 = None, os.getloadavg()[0]
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        length = min(seconds, float(cell.traffic.get("trace_seconds", seconds)))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                window = drv.run(length)
        trace = tracing.fromProfiler(prof)
        del prof
        drv.countWork(window)
    else:
        window = drv.run(seconds)
    load1 = os.getloadavg()[0]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    numbers = drv.check()
    phases = {"imports": tImport - t0, **{k: v - t0 for k, v in drv.phases.items()}}
    return Run(setup, window, trace, (load0, load1), phases), peak, numbers


def readMetrics(cell, run: Run, traced: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each from its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in (cell.perLayer if traced else cell.endToEnd):
        value = cell.reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(cell, window: Window, numbers: Dict[str, float]):
    """(correct, checks): each compared number beside its limit; a number
    that is missing or not finite fails, as does a request that failed."""
    checks, ok = {}, window.failed == 0 and window.attempted > 0
    for name, limit in cell.limits["compare"].items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
