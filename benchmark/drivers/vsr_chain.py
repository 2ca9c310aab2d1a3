"""The video route's chain for video super-resolution, one clip a job.

Each job is what one user's video request does: a fresh
``video/engine.prepare(...)`` with the configuration's steps, its
``process`` fed the clip's raw 16-bit BGR frames one by one (as ``SR_vid``
feeds it from the decoder pipe), then the end of the stream as ``SR_vid``
signals it: each padded temporal step told to pad its tail by its
lookahead, and the closing call.  Everything between is the program's:
``fromBuffer``, the channel flips, the VSR step's stream graph and model,
the output quantisation, the copy to the host and ``toBuffer``.  Jobs run
back to back; one whole job warms the chain before the window.

Items are output frames: output ``j`` of a job is the x4 of clip frame
``j``.  The check runs the plain fp32 reference over the clip once
(``reference/iconvsr.vsrClip``: every job runs the same clip) and
compares a seeded sample of the window's output frames, the first and
the last, in 16-bit steps.
"""

import copy
import os
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.harness.cell import Item, Sample, Window
from benchmark.harness.weights import DTYPES, drawWeights
from benchmark.reference import iconvsr, vsrwork
from benchmark.reference.layers import setQuant


@dataclass
class VsrItem(Item):
    frame: int = -1  # the clip frame behind this output
    k3: float = 0.0  # K3's least seconds for this frame's keyframe clip


class Driver:
    def __init__(self, cell, seed: int, device, workdir: str):
        from moephoto_tpu_torch.config import config

        cfg, mix = cell.config, cell.traffic
        self.phases = {"driver_start": time.perf_counter()}
        self.device = torch.device(device)
        self.dtype = cfg["dtype"]
        self.steps = cfg["steps"]
        self.blocks = int(cfg["num_block"])
        config.device = self.device.type
        config.modelDir = workdir
        config.opsPath = os.path.join(workdir, "ops.json")

        model = iconvsr.IconVSR(self.blocks).to("meta")
        self.weights = drawWeights(model, cfg["weights"], seed, self.device, DTYPES[self.dtype])
        path = os.path.join(workdir, cfg["checkpoint"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(iconvsr.checkpoint(self.weights), path)

        self.phases["weights"] = time.perf_counter()
        self.h, self.w = int(mix["height"]), int(mix["width"])
        self.frames = traffic.makeClip(mix, seed, self.device)
        self.phases["traffic"] = time.perf_counter()
        self.sample, self.last = Sample(mix["sample"], seed), None
        self.process = None
        for _ in range(int(mix["warm_jobs"])):
            self.start()
            while self.process is not None:
                self.push()
        self.phases["warm"] = time.perf_counter()

    def start(self):
        """A fresh chain for the next job, as a new request prepares one."""
        from moephoto_tpu_torch.video.engine import prepare

        self.chain = [{}, {}, *copy.deepcopy(self.steps), {}]
        p = prepare("benchmark", "benchmark", self.chain)
        self.process, self.refs, self.fed, self.emitted = p["process"], p["refs"], 0, 0

    def endOfStream(self):
        """``SR_vid``'s tail when the decoder's stream ends: each padded
        temporal step pads by its lookahead."""
        from moephoto_tpu_torch.video.engine import lookaheadOf, padOp

        refs = self.refs
        for step in self.chain[2:-1]:
            if refs <= 0:
                break
            if step["op"] in padOp:
                step["opt"].end = -min(refs, lookaheadOf(step["op"]))
                refs += step["opt"].end

    def push(self):
        """The job's next call: its next frame, or the end of its stream
        (the job then ends)."""
        if self.fed < len(self.frames):
            out = self.process((self.frames[self.fed], self.h, self.w))
            self.fed += 1
            return out
        self.endOfStream()
        out = self.process((None, self.h, self.w))
        self.process = None
        return out

    def run(self, seconds: float) -> Window:
        from torch.profiler import record_function

        win = Window(time.perf_counter(), 0.0)
        inPx, outPx = self.h * self.w, self.h * self.w * iconvsr.SCALE**2
        while True:
            with record_function("bench.frame"):
                t0 = time.perf_counter()
                try:
                    if self.process is None:
                        self.start()
                    outs = self.push()
                except Exception:  # a failed call counts in failed; the next job starts afresh
                    traceback.print_exc(file=sys.stderr)
                    outs, self.process = None, None
                t1 = time.perf_counter()
            if outs is None:
                win.attempted += 1
                win.failed += 1
                win.items.append(VsrItem(t0, t1, ok=False))
            for buf in [b for b in outs or () if b]:  # the stream's closing call ends in None, as SR_vid skips it
                win.attempted += 1
                j = self.emitted
                self.emitted += 1
                win.items.append(VsrItem(t0, t1, inPx, outPx, shape=(self.h, self.w), frame=j))
                self.sample.offer(outPx, (j, buf))
                self.last = (j, buf)
            if t1 - win.t0 >= seconds and outs:
                win.t1 = t1
                return win

    def countWork(self, win: Window):
        """Each output frame's FLOPs and K2's least time, and K3's on keyframe
        frames, from the reference's schedule at the clip's own size (after
        the window: only the per-layer metrics read them)."""
        n, h, w = len(self.frames), self.h, self.w
        k3 = vsrwork.k3KeyframeBound(h, w, self.dtype)
        for item in win.done():
            t = item.frame
            item.flops = vsrwork.frameFlops(t, n, h, w, self.blocks)
            item.k2 = vsrwork.k2FrameBound(t, n, h, w, self.dtype)
            item.k3 = k3 if iconvsr.isKeyframe(t, n) else 0.0

    def release(self):
        """The open job's stream ended and dropped, outside the window."""
        while self.process is not None:
            self.push()
        self.chain = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> iconvsr.IconVSR:
        model = iconvsr.IconVSR(self.blocks)
        model.load_state_dict({k: v.float() for k, v in self.weights.items()}, strict=True)
        return setQuant(model.to(self.device).eval(), quant)

    def controlEntries(self, k: int, quant):
        """The reference at ``quant`` in the program's place on ``k`` frames
        spread over the clip, the last included."""
        n = len(self.frames)
        keep = sorted({int(round(i * (n - 1) / max(1, k - 1))) for i in range(k)})
        outs = iconvsr.vsrClip(self.reference(quant), self.frames, self.h, self.w, self.device, keep)
        return [(t, outs[t].tobytes()) for t in keep]

    def check(self, entries=None) -> dict:
        """Worst RMS and widest gap, in 16-bit steps, of the sampled output
        frames against the fp32 reference."""
        if entries is None:
            entries = self.sample.entries() + ([self.last] if self.last is not None else [])
        outs = iconvsr.vsrClip(self.reference(), self.frames, self.h, self.w, self.device, {t for t, _ in entries})
        rms, gap = 0.0, 0.0
        for t, buf in entries:
            if len(buf) != outs[t].nbytes:
                return {"rms_lsb16": float("inf"), "max_lsb16": float("inf")}
            got = np.frombuffer(buf, dtype=np.uint16).reshape(outs[t].shape)
            d = torch.from_numpy(got.astype(np.float32)).to(self.device) - torch.from_numpy(
                outs[t].astype(np.float32)).to(self.device)
            rms = max(rms, float(d.square().mean().sqrt()))
            gap = max(gap, float(d.abs().max()))
        return {"rms_lsb16": rms, "max_lsb16": gap}
