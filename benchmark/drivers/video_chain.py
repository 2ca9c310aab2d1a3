"""The video route's chain without its ffmpeg processes.

``video/engine.prepare(...)["process"]`` is the per-frame function that
``SR_vid`` feeds with ``(rawFrame, height, width)`` from the decoder pipe
and whose output buffers it writes to the encoder pipe; this driver
feeds it the clip's raw 16-bit BGR frames from memory and drops the
buffers it returns (keeping a seeded sample).  Between them everything
is the program's: ``fromBuffer``, the channel flips, the temporal step's
stream graph and model, the copy to the host, ``toOutput`` and
``toBuffer``.  The end-of-stream call comes after the window.

For slomo x2 the outputs alternate: output ``j`` is input frame ``j / 2``
for even ``j``, and the frame between inputs ``j // 2`` and ``j // 2 + 1``
for odd ``j`` (counted from the first frame the chain was fed).  The
check runs the plain reference (``reference/ifrnet.py``, fp32) for a
seeded sample of the window's interpolated frames and compares the
16-bit outputs, and holds a sample of the passed-through input frames to
be bit-equal to the input.
"""

from __future__ import annotations

import copy
import os
import sys
import time
import traceback

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.harness.cell import Item, Sample, Window
from benchmark.harness.weights import DTYPES, drawWeights
from benchmark.reference import bounds, flops, ifrnet
from benchmark.reference.layers import fp32Exact, setQuant


class Driver:
    def __init__(self, cell, seed: int, device, workdir: str):
        from moephoto_tpu_torch.config import config
        from moephoto_tpu_torch.video.engine import prepare

        cfg, mix = cell.config, cell.traffic
        self.phases = {"driver_start": time.perf_counter()}
        self.device = torch.device(device)
        self.dtype = cfg["dtype"]
        config.device = self.device.type
        config.modelDir = workdir
        config.opsPath = os.path.join(workdir, "ops.json")

        model = ifrnet.IFRNetM().to("meta")
        self.weights = drawWeights(model, cfg["weights"], seed, self.device, DTYPES[self.dtype])
        path = os.path.join(workdir, cfg["checkpoint"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(ifrnet.checkpoint(self.weights), path)

        self.phases["weights"] = time.perf_counter()
        self.h, self.w = int(mix["height"]), int(mix["width"])
        self.frames = traffic.makeClip(mix, seed, self.device)
        self.phases["traffic"] = time.perf_counter()
        self.interp, self.orig = Sample(mix["sample"], seed), Sample(mix["sample"], seed + 1)
        self.process = prepare("benchmark", "benchmark", [{}, {}, *copy.deepcopy(cfg["steps"]), {}])["process"]
        self.phases["chain"] = time.perf_counter()
        self.fed = self.emitted = 0
        while self.fed < int(mix["warm_frames"]):
            self.emitted += len(self.push())
        self.phases["warm"] = time.perf_counter()

    def push(self):
        out = self.process((self.frames[self.fed % len(self.frames)], self.h, self.w))
        self.fed += 1
        return out

    def pair(self, j: int):
        """Input frame indices (into the clip) behind output ``j``: one for
        an input frame passed through, two for an interpolated frame."""
        n = len(self.frames)
        return ((j // 2) % n,) if j % 2 == 0 else ((j // 2) % n, (j // 2 + 1) % n)

    def run(self, seconds: float) -> Window:
        from torch.profiler import record_function

        win = Window(time.perf_counter(), 0.0)
        px = self.h * self.w
        while True:
            with record_function("bench.frame"):
                t0 = time.perf_counter()
                try:
                    outs = self.push()
                except Exception:  # a failed call counts in failed; the loop goes on
                    traceback.print_exc(file=sys.stderr)
                    outs = None
                t1 = time.perf_counter()
            if outs is None:
                win.attempted += 1
                win.failed += 1
                win.items.append(Item(t0, t1, ok=False))
            for buf in outs or ():
                j = self.emitted
                self.emitted += 1
                win.attempted += 1
                if j % 2:
                    win.items.append(Item(t0, t1, 0, px, shape=(self.h, self.w), interpolated=True))
                    self.interp.offer(px, (j, buf))
                else:
                    win.items.append(Item(t0, t1, 0, px))
                    self.orig.offer(px, (j, buf))
            if t1 - win.t0 >= seconds and outs:
                win.t1 = t1
                return win

    def countWork(self, win: Window):
        """IFRNet-M's FLOPs and K2's least time for each interpolated frame
        at the clip's own size, from the reference (after the window: only
        the per-layer metrics read them)."""
        fl, k2 = flops.ifrnetFrameFlops(self.h, self.w), bounds.k2FrameBound(self.h, self.w, ifrnet.WIDTHS, self.dtype)
        for item in win.done():
            if item.interpolated:
                item.flops, item.k2 = fl, k2

    def release(self):
        self.process((None, self.h, self.w))  # the end of the stream, outside the window
        self.process = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> ifrnet.IFRNetM:
        model = ifrnet.IFRNetM()
        model.load_state_dict({k: v.float() for k, v in self.weights.items()}, strict=True)
        return setQuant(model.to(self.device).eval(), quant)

    def controlEntries(self, k: int, quant):
        """The reference at ``quant`` in the program's place on the first
        ``k`` interpolated frames after the warm-up, and as many input
        frames passed through."""
        model = self.reference(quant)
        out = []
        with fp32Exact():
            for j in range(self.emitted | 1, (self.emitted | 1) + 2 * k, 2):
                a, b = self.pair(j)
                y = ifrnet.interpolateFrames(model, self.frames[a], self.frames[b], self.h, self.w, self.device)
                out.append((j, y.tobytes()))
                out.append((j + 1, self.frames[self.pair(j + 1)[0]]))
        return out

    def check(self, entries=None) -> dict:
        """Worst RMS and widest gap, in 16-bit steps, of the sampled
        interpolated frames against the fp32 reference; the number of
        sampled input frames that did not come back bit-equal."""
        if entries is None:
            entries = self.interp.entries() + self.orig.entries()
        model = self.reference()
        rms, gap, differ = 0.0, 0.0, 0
        with fp32Exact():
            for j, buf in entries:
                src = self.pair(j)
                if len(src) == 1:
                    differ += int(buf != self.frames[src[0]])
                    continue
                if len(buf) != self.h * self.w * 6:
                    return {"rms_lsb16": float("inf"), "max_lsb16": float("inf"), "originals_differing": differ}
                ref = ifrnet.interpolateFrames(model, self.frames[src[0]], self.frames[src[1]], self.h, self.w,
                                               self.device)
                got = np.frombuffer(buf, dtype=np.uint16).reshape(self.h, self.w, 3)
                d = torch.from_numpy(got.astype(np.float32)).to(self.device) - torch.from_numpy(
                    ref.astype(np.float32)).to(self.device)
                rms = max(rms, float(d.square().mean().sqrt()))
                gap = max(gap, float(d.abs().max()))
        return {"rms_lsb16": rms, "max_lsb16": gap, "originals_differing": differ}
