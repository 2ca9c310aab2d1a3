"""Arithmetic shared by the metric readers (``benchmark/metrics/``).

Each reader's ``read(run)`` returns its metric's value from the window's
record (``run.window``: one item per image, or per output frame) and, in a
traced run, the profiler's record of the window (``run.trace``); it
returns None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness import trace as tracing
from benchmark.reference.bounds import PEAK_BF16_FLOPS


def mpxPerSecond(run, field: str) -> Optional[float]:
    done = run.window.done()
    if not done or run.window.seconds <= 0:
        return None
    return sum(getattr(i, field) for i in done) / run.window.seconds / 1e6


def perItemMs(run, seconds: float) -> Optional[float]:
    n = len(run.window.done())
    return seconds / n * 1e3 if n and run.trace is not None else None


def copyMs(run) -> Optional[float]:
    if run.trace is None:
        return None
    return perItemMs(run, sum(e - s for _, s, e in run.trace.copies()))


def launches(run) -> Optional[float]:
    n = len(run.window.done())
    return len(run.trace.kernels()) / n if n and run.trace is not None else None


def elementwiseMs(run) -> Optional[float]:
    """Device ms an item in kernels that are neither library convolutions
    and products nor the port's own kernels (copies are no kernels)."""
    if run.trace is None:
        return None
    t = sum(e - s for n, s, e in run.trace.kernels()
            if not tracing.LIBRARY.search(n) and not tracing.PORT.search(n))
    return perItemMs(run, t)


def roofline(run, field: str, pattern) -> Optional[float]:
    """Percent: the kernel's least time for the window's work over its
    device time in the window; None where it did not run."""
    if run.trace is None:
        return None
    t = run.trace.seconds(pattern)
    work = sum(getattr(i, field) for i in run.window.done())
    return 100.0 * work / t if t > 0 and work > 0 else None


def idle(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def mfu(run) -> Optional[float]:
    """Percent of the bf16 peak: the model's operations for the window's
    inputs over the window's wall time."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    work = sum(i.flops for i in run.window.done())
    return 100.0 * work / (run.trace.window_s * PEAK_BF16_FLOPS) if work > 0 else None
