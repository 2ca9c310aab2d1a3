"""Shared harness for temporal stream models (reference
``python/runSlomo.py``): a per-frame driver with start/end reflection
padding, output trimming for segment resume, and input alignment
padding.  Frames are HWC tensors on the compute device."""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F


class StreamOpt:
    """Option object carried by a video step (reference ``getOptP``
    runSlomo.py:56-63, plus the video engine's start/end protocol)."""

    def __init__(self):
        self.startPadding = 0
        self.i = 0
        self.currentSize = 0
        self.outStart = 0
        self.outEnd = 0
        self.start = 0
        self.end = 0
        self.pad = lambda x: x
        self.unpad = lambda x: x


def ceilBy(d: int) -> Callable[[int], int]:
    return lambda x: -(-int(x) // d) * d


def alignPad(x: torch.Tensor, align: int):
    """Reflection-pad an (H, W, C) frame bottom/right to a multiple of
    ``align``; returns (pad, unpad, (H, W)).  Reflection needs each pad
    smaller than the frame's side."""
    h, w = x.shape[0], x.shape[1]
    H, W = ceilBy(align)(h), ceilBy(align)(w)

    def pad(f):
        if (H, W) == (h, w):
            return f
        # F.pad pads the trailing axes of a (N, C, H, W) tensor
        y = F.pad(f.permute(2, 0, 1)[None], (0, W - w, 0, H - h), mode="reflect")
        return y[0].permute(1, 2, 0).contiguous()

    def unpad(f):
        return f[:h, :w]

    return pad, unpad, (H, W)


def extendRes(res: List, item):
    if isinstance(item, list):
        res.extend(item)
    elif item is not None:
        res.append(item)


def makeStreamFunc(
    func: Callable,
    node,
    opt: StreamOpt,
    nodes: Sequence,
    name: str,
    padStates: Sequence,
    initFunc: Callable,
    putFunc: Callable,
    graph,
    sink: List,
):
    """The per-frame function of a temporal step (reference
    ``makeStreamFunc`` runSlomo.py:66-108).

    ``func`` is the downstream per-frame pipeline and ``sink`` the list
    the graph's last stage appends outputs to.  ``func`` must take one
    ``None`` call at the end of the stream (the forwarded flush sentinel)
    and return ``None``: the functions ``pipeline/steps.py`` builds are
    wrapped to do so.
    """
    for n in nodes:
        node.append(n)

    def f(x):
        node.reset()
        node.trace(0, p="{} start".format(name))
        if not opt.currentSize and x is not None:
            opt.currentSize = initFunc(opt, x)
        if opt.end:
            for s in padStates:
                s.setPadding(opt.end)
            opt.end = 0
        if opt.start:
            opt.startPadding = opt.start
            for s in padStates:
                s.setPadding(opt.start)
            opt.start = 0
        last = x is None
        if not last:
            putFunc(opt.pad(x))
            opt.i += 1
            graph.run()
        else:
            graph.run(last=True)
        out = list(sink)
        del sink[:]
        if last and opt.outEnd:
            out = out[: opt.outEnd]
            opt.outEnd = 0
        l = len(out)
        out = out[opt.outStart :]
        opt.outStart = max(0, opt.outStart - l)
        node.trace(len(out))
        res: List = []
        for item in out:
            extendRes(res, func(opt.unpad(item)))
        if last:
            # forward the end-of-stream sentinel so a chained temporal
            # step flushes its own graph too: the eager StreamGraph emits
            # a stage's tail only under run(last=True)
            extendRes(res, func(None))
        return res

    return f
