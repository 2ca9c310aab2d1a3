"""The profiler's record of a traced window, reduced to what the
per-layer metrics read.

The window is the span of the ``bench.window`` annotation that the
harness opens around the measured loop.  Device events are the kernels
and the copies and sets of memory (the profiler's device-side events,
less the device spans of annotations); host events are the operators,
runtime calls and annotations of the profiled process.  The device is
busy where any device event runs: the union of their intervals, so
overlapping work counts once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"

# Name classes of device kernels.  Library convolutions and products:
# cuDNN, cuBLAS and CUTLASS kernels and cuDNN's layout conversions.
LIBRARY = re.compile(r"cudnn|xmma|cutlass|gemm|gemv|implicit_convolve|conv2d|convolve|winograd|fft2d|"
                     r"cublas|nchwToNhwc|nhwcToNchw|^(void )?(sm\d+|ampere|hopper|turing|volta)_", re.I)
# the port's own kernels (csrc/*.cu): K1, K2, K3, K4/K5
PORT = re.compile(r"fusedUpHeads|warpVecKernel|warpPixelKernel|dcnKernel|dcnMmaKernel|ailutKernel")
K1 = re.compile(r"fusedUpHeads")
K2 = re.compile(r"warpVecKernel|warpPixelKernel")


def isCopy(name: str) -> bool:
    return name.startswith("Memcpy")


def isSet(name: str) -> bool:
    return name.startswith("Memset")


Interval = Tuple[float, float]  # seconds from the profiler's start


@dataclass
class Trace:
    window: Interval
    device: List[Tuple[str, float, float]]  # (name, start, end), clipped to the window
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not isCopy(e[0]) and not isSet(e[0])]

    def copies(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if isCopy(e[0])]

    def seconds(self, pattern: re.Pattern) -> float:
        """Device seconds of the kernels whose names match ``pattern``."""
        return sum(e - s for n, s, e in self.kernels() if pattern.search(n))

    def busy(self) -> List[Interval]:
        """The union of the device events' intervals, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self) -> List[Interval]:
        """Idle stretches of the window, longest first."""
        t, out = self.window[0], []
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def outerOps(self) -> List[Tuple[str, float, float]]:
        """The torch operators the host called from Python: ``aten::``
        events that lie inside no other ``aten::`` event."""
        out, end = [], float("-inf")
        for ev in sorted((h for h in self.host if h[0].startswith("aten::")), key=lambda h: (h[1], -h[2])):
            if ev[1] >= end:
                out.append(ev)
                end = ev[2]
        return out

    def label(self, gap: Interval) -> str:
        """What the host was doing over ``gap``: the innermost host event
        that covers at least half of it, else the one that covers most of
        it.  Where that is one of the benchmark's own annotations (the
        program's Python and numpy code records no event of its own), the
        torch operators around the gap name it: the last one to start
        before it and the first one to end after it."""
        g0, g1 = gap
        length = max(g1 - g0, 1e-12)
        best, bestCover, inner = None, 0.0, None
        for name, s, e in self.host:
            if e <= g0 or s >= g1 or name == WINDOW:
                continue
            cover = (min(e, g1) - max(s, g0)) / length
            if cover >= 0.5 and (inner is None or e - s < inner[1]):
                inner = (name, e - s)
            if cover > bestCover:
                best, bestCover = name, cover
        name = inner[0] if inner else best
        if name is None or name.startswith("bench."):
            ops = self.outerOps()
            before = max((h for h in ops if h[1] <= g0), key=lambda h: h[1], default=None)
            after = min((h for h in ops if h[2] >= g1), key=lambda h: h[2], default=None)
            return "{}: host after {} before {}".format(name or "no profiled host call",
                                                         before[0] if before else "-", after[0] if after else "-")
        return name

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        totals: Dict[str, float] = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        gaps = [[self.label(g), g[1] - g[0]] for g in self.gaps()[:n]]
        return {"device_ops": [[k[:200], v] for k, v in ops], "idle_gaps": gaps}


def fromProfiler(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window, device, host = None, [], []
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == cuda:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
            if ev.name == WINDOW:
                window = (s, e)
    if window is None:
        raise RuntimeError("the traced window's annotation is missing from the profile")
    w0, w1 = window
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    return Trace(window, device, host)
