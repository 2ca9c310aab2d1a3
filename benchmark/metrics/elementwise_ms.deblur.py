"""Device ms an image in kernels that are neither library convolutions and products (trace.LIBRARY's, and cuBLASLt's nvjet GEMMs), nor the port's own kernels, nor K7's blendKernel, nor the channel attention's means (pool_ms.deblur's kernels), nor copies: MPRNet's PReLUs, the attention's sigmoid gates and products, the residual and fusion adds, the bilinear resamples and the quadrant and half copies."""

import os
import re

from benchmark.harness import trace
from benchmark.harness.readers import perItemMs
from benchmark.harness.spec import loadFile

# kernels that trace.LIBRARY and trace.PORT do not name: cuBLASLt's Hopper GEMMs and K7
NOT_ELEMENTWISE = re.compile(r"^nvjet_|blendKernel")
MEAN = loadFile(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pool_ms.deblur.py"),
                "benchmark.metrics.pool_ms__deblur").MEAN


def read(run):
    if run.trace is None:
        return None
    t = sum(e - s for n, s, e in run.trace.kernels()
            if not any(p.search(n) for p in (trace.LIBRARY, trace.PORT, NOT_ELEMENTWISE, MEAN)))
    return perItemMs(run, t)
