"""The program's own spans and counters in a traced window, for the
per-layer metrics that read them.

The program (``moephoto_tpu_torch/progress.py``) records them as ranges
of the torch profiler, so they are host events of the trace named
``moe.*``: ``moe.step.<op>`` around each bound step, ``moe.sync`` around
each device synchronisation, ``moe.engine.chunk`` around each chunk of
tiles, ``moe.stream.run`` around each pass of the stream graph, and
``moe.count.<name>=<n>`` for a count.  A reader returns None where the
window holds no ``moe.`` event at all: a program that records none.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PREFIX = "moe."
COUNT = "moe.count."

Event = Tuple[str, float, float]


def inWindow(run) -> Optional[List[Event]]:
    """The window's ``moe.`` host events, clipped to it; None where the run
    was not traced or the window holds none."""
    if run.trace is None:
        return None
    w0, w1 = run.trace.window
    out = [(n, max(s, w0), min(e, w1)) for n, s, e in run.trace.host
           if n.startswith(PREFIX) and e >= w0 and s <= w1]
    return out or None


def union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by ``intervals``, overlaps counted once."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def named(events: List[Event], names) -> List[Event]:
    """The events whose names are in ``names``."""
    return [ev for ev in events if ev[0] in names]


def counts(events: List[Event], name: str) -> List[int]:
    """The values of the window's ``moe.count.<name>=<n>`` ranges."""
    head = f"{COUNT}{name}="
    return [int(n[len(head):]) for n, _, _ in events if n.startswith(head)]


def selfSeconds(events: List[Event], name: str, childPrefix: str) -> float:
    """Seconds of the ``name`` spans less what the spans named
    ``childPrefix...`` cover inside them."""
    children = [(s, e) for n, s, e in events if n.startswith(childPrefix)]
    total = 0.0
    for _, s, e in named(events, {name}):
        inner = [(max(cs, s), min(ce, e)) for cs, ce in children if ce > s and cs < e]
        total += (e - s) - union(inner)
    return total


def perItem(run, value: float) -> Optional[float]:
    n = len(run.window.done())
    return value / n if n else None


def perItemMs(run, names) -> Optional[float]:
    """Host ms an item inside the spans named ``names``."""
    events = inWindow(run)
    return None if events is None else perItem(run, union((s, e) for _, s, e in named(events, names)) * 1e3)


# the steps of the output path after the copy to the host
OUTPUT_STEPS = {"moe.step.toOutput", "moe.step.Channel", "moe.step.toBuffer"}


def outputHostMs(run) -> Optional[float]:
    return perItemMs(run, OUTPUT_STEPS)


def syncMs(run) -> Optional[float]:
    return perItemMs(run, {"moe.sync"})


def syncs(run) -> Optional[float]:
    events = inWindow(run)
    return None if events is None else perItem(run, float(len(named(events, {"moe.sync"}))))


def engineHostMs(run) -> Optional[float]:
    return perItemMs(run, {"moe.engine.chunk"})


def tileUse(run) -> Optional[float]:
    """Percent: the tiles the window's chunks needed over the tiles they ran."""
    events = inWindow(run)
    if events is None:
        return None
    ran = sum(counts(events, "tiles_run"))
    return 100.0 * sum(counts(events, "tiles_needed")) / ran if ran else None


def streamSelfMs(run) -> Optional[float]:
    """Host ms an item in the stream graph's passes outside the steps they run."""
    events = inWindow(run)
    return None if events is None else perItem(run, selfSeconds(events, "moe.stream.run", "moe.step.") * 1e3)
