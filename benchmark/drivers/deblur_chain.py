"""The image route's chain for a deblurring model, without its two codec
ends: ``image_chain``'s request loop with MPRNet in the dehaze step.

For each request the chain is ``genProcess([{"op": "file"}, {"op":
"dehaze", "model": ...}])`` under ``runtime/worker.begin``, the decoded
uint8 array in and the uint8 array the encoder would get out
(``image_chain``'s ``bypassCodec``).  Between them everything is the
program's: the upload and conversion, the dehaze step's ``ModelExec`` and
tiler on RGB tiles (``registry.getDehaze``), the copy to the host and the
quantisation.  Items are images, each as large out as in.

The check runs the plain reference (``reference/mprnet.py``: the tiler on
RGB tiles and MPRNet in fp32) on a seeded sample of the window's images
and the largest, and compares the 8-bit outputs.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.drivers.image_chain import Driver as ImageDriver
from benchmark.drivers.image_chain import bypassCodec
from benchmark.harness import traffic
from benchmark.harness.cell import Sample, Window
from benchmark.harness.weights import DTYPES, drawWeights
from benchmark.reference import deblurwork, mprnet
from benchmark.reference.layers import fp32Exact, setQuant


class Driver(ImageDriver):
    def __init__(self, cell, seed: int, device, workdir: str):
        from moephoto_tpu_torch.config import config
        from moephoto_tpu_torch.progress import Node

        cfg, mix = cell.config, cell.traffic
        self.phases = {"driver_start": time.perf_counter()}
        self.device = torch.device(device)
        self.cfg, self.spec, self.steps = cfg, cfg["tile_spec"], cfg["steps"]
        self.upscale, self.dtype = 1, cfg["dtype"]
        config.device = self.device.type
        config.modelDir = workdir
        config.opsPath = os.path.join(workdir, "ops.json")

        model = mprnet.fromConfig(cfg).to("meta")
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

    def countWork(self, win: Window):
        """MPRNet's FLOPs for each image's own size, from the reference
        (after the window: only the per-layer metrics read them)."""
        c = self.cfg
        for item in win.done():
            item.flops = deblurwork.imageFlops(*item.shape, int(c["n_feat"]), int(c["scale_unetfeats"]),
                                               int(c["scale_orsnetfeats"]), int(c["num_cab"]))

    def reference(self, quant=None) -> mprnet.MPRNet:
        model = mprnet.fromConfig(self.cfg)
        model.load_state_dict({k: v.float() for k, v in self.weights.items()}, strict=True)
        return setQuant(model.to(self.device).eval(), quant)

    def controlEntries(self, k: int, quant):
        """The reference at ``quant`` in the program's place, on the first
        ``k`` requests and the pool's largest image."""
        model = self.reference(quant)
        idxs = list(dict.fromkeys(self.order[:k] + [max(range(len(self.pool)), key=lambda i: self.pool[i].size)]))
        with fp32Exact():
            return [(i, mprnet.deblurImage(model, self.pool[i], self.spec, self.device).cpu().numpy()) for i in idxs]

    def check(self, entries=None) -> dict:
        """Worst RMS and widest gap, in 8-bit steps, of the sampled outputs
        against the fp32 reference."""
        entries = self.sample.entries() if entries is None else entries
        model = self.reference()
        rms, gap = 0.0, 0.0
        with fp32Exact():
            for idx, out in entries:
                ref = mprnet.deblurImage(model, self.pool[idx], self.spec, self.device)
                got = torch.from_numpy(np.ascontiguousarray(out)).to(self.device)
                if got.shape != ref.shape:
                    return {"rms_lsb8": float("inf"), "max_lsb8": float("inf")}
                d = got.float() - ref.float()
                rms = max(rms, float(d.square().mean().sqrt()))
                gap = max(gap, float(d.abs().max()))
        return {"rms_lsb8": rms, "max_lsb8": gap}
