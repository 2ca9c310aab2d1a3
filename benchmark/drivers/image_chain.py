"""The image route's chain without its two codec ends.

For each request the worker's image route compiles the step list with
``pipeline/steps.genProcess([{"op": "file"}, *steps])`` and runs it under
the progress tree of ``runtime/worker.begin``; so does this driver.  The
chain's file step reads a request from the shared-memory block and
decodes it (PIL), and its last step encodes the result; here the request
is the decoded uint8 (H, W, 3) array and the result the uint8 array that
the encoder would get.  Between them everything is the program's: the
upload and conversion (``toDevice``), the configuration's steps, the
copy to the host (``toFloatHost``) and the quantisation
(``imageio.toOutput``), with the device waited for after every step.

The check runs the plain reference (``reference/lite.py``: the tiler and
MoeNet_lite2 in fp32) on a seeded sample of the window's images and the
largest, and compares the 8-bit outputs.
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
from benchmark.reference import bounds, flops, lite
from benchmark.reference.layers import fp32Exact, setQuant


def bypassCodec():
    """Make the chain's file step take the decoded array as its request
    and its write step return the array it would encode."""
    from moephoto_tpu_torch.runtime.context import context
    from moephoto_tpu_torch.utils import imageio

    def readDecoded(image, ctx=None):
        if ctx is not None:
            ctx.imageMode = "RGB"
        return image

    context.getFile = lambda request: request
    imageio.readFile = readDecoded
    imageio.writeFile = lambda image, name=None, ctx=None, *args: image


class Driver:
    def __init__(self, cell, seed: int, device, workdir: str):
        from moephoto_tpu_torch.config import config
        from moephoto_tpu_torch.progress import Node

        cfg, mix = cell.config, cell.traffic
        self.phases = {"driver_start": time.perf_counter()}
        self.device = torch.device(device)
        self.spec, self.steps = cfg["tile_spec"], cfg["steps"]
        self.upscale, self.dtype = int(cfg["upscale"]), cfg["dtype"]
        config.device = self.device.type
        config.modelDir = workdir
        config.opsPath = os.path.join(workdir, "ops.json")

        model = lite.MoeNetLite2(self.upscale).to("meta")
        self.weights = drawWeights(model, cfg["weights"], seed, self.device, DTYPES[self.dtype])
        path = os.path.join(workdir, cfg["checkpoint"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(self.weights, path)

        self.phases["weights"] = time.perf_counter()
        self.pool, self.order = traffic.makeImages(mix, seed, self.device)
        self.phases["traffic"] = time.perf_counter()
        self.sample = Sample(mix["sample"], seed)
        bypassCodec()
        self.root = Node({"op": "image"}, learn=0)
        self.warm()
        self.phases["warm"] = time.perf_counter()

    def chain(self, image):
        """One request through the route's chain, compiled for it."""
        from moephoto_tpu_torch.pipeline.steps import genProcess
        from moephoto_tpu_torch.runtime.worker import begin

        process, nodes = genProcess([{"op": "file"}, *copy.deepcopy(self.steps)])
        return begin(self.root, nodes, False, False).bindFunc(process)(image, name="bench")

    def tileShape(self, h: int, w: int):
        s = self.spec
        return (min(s["tile"], lite.paddedExtent(h, s["tile"], s["pad"], s["align"])),
                min(s["tile"], lite.paddedExtent(w, s["tile"], s["pad"], s["align"])))

    def warm(self):
        """One request of each model shape the pool's images make."""
        seen = set()
        for img in self.pool:
            shape = self.tileShape(*img.shape[:2])
            if shape not in seen:
                seen.add(shape)
                self.chain(img)

    def run(self, seconds: float) -> Window:
        from torch.profiler import record_function

        win = Window(time.perf_counter(), 0.0)
        i, n = 0, len(self.pool)
        while True:
            idx = self.order[i % n]
            img = self.pool[idx]
            h, w = img.shape[:2]
            with record_function("bench.request"):
                t0 = time.perf_counter()
                try:
                    out, ok = self.chain(img), True
                except Exception:  # a failed request counts in failed; the loop goes on
                    traceback.print_exc(file=sys.stderr)
                    out, ok = None, False
                t1 = time.perf_counter()
            win.attempted += 1
            win.items.append(Item(t0, t1, h * w, h * w * self.upscale**2, ok=ok, shape=(h, w)))
            if ok:
                self.sample.offer(h * w, (idx, out))
            else:
                win.failed += 1
            i += 1
            if t1 - win.t0 >= seconds:
                win.t1 = t1
                return win

    def countWork(self, win: Window):
        """The model's FLOPs and K1's least time for each image's own size,
        from the reference (after the window: only the per-layer metrics
        read them)."""
        nUps = self.upscale.bit_length() - 1
        for item in win.done():
            h, w = item.shape
            item.flops = flops.liteImageFlops(h, w, 3, self.upscale)
            item.k1 = bounds.k1ImageBound(h, w, 3, lite.NF, nUps, self.dtype)

    def release(self):
        self.root = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> lite.MoeNetLite2:
        model = lite.MoeNetLite2(self.upscale)
        model.load_state_dict({k: v.float() for k, v in self.weights.items()}, strict=True)
        return setQuant(model.to(self.device).eval(), quant)

    def controlEntries(self, k: int, quant):
        """The reference at ``quant`` in the program's place, on the first
        ``k`` requests and the pool's largest image."""
        model = self.reference(quant)
        idxs = list(dict.fromkeys(self.order[:k] + [max(range(len(self.pool)), key=lambda i: self.pool[i].size)]))
        with fp32Exact():
            return [(i, lite.srImage(model, self.pool[i], self.spec, self.device).cpu().numpy()) for i in idxs]

    def check(self, entries=None) -> dict:
        """Worst RMS and widest gap, in 8-bit steps, of the sampled outputs
        against the fp32 reference."""
        entries = self.sample.entries() if entries is None else entries
        model = self.reference()
        rms, gap = 0.0, 0.0
        with fp32Exact():
            for idx, out in entries:
                ref = lite.srImage(model, self.pool[idx], self.spec, self.device)
                got = torch.from_numpy(np.ascontiguousarray(out)).to(self.device)
                if got.shape != ref.shape:
                    return {"rms_lsb8": float("inf"), "max_lsb8": float("inf")}
                d = got.float() - ref.float()
                rms = max(rms, float(d.square().mean().sqrt()))
                gap = max(gap, float(d.abs().max()))
        return {"rms_lsb8": rms, "max_lsb8": gap}
