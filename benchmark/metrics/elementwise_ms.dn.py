"""Device ms an image in kernels that are neither library convolutions and products (trace.LIBRARY's, and cuBLASLt's nvjet GEMMs that run NAFNet's 1x1 convs), nor the port's own kernels, nor K7's blendKernel, nor layer norm (norm_ms.dn's kernels), nor copies: NAFNet's gates, SCA's means and products, the bias adds and the scaled residuals."""

import os
import re

from benchmark.harness import trace
from benchmark.harness.readers import perItemMs
from benchmark.harness.spec import loadFile

# kernels that trace.LIBRARY and trace.PORT do not name: cuBLASLt's Hopper GEMMs and K7
NOT_ELEMENTWISE = re.compile(r"^nvjet_|blendKernel")
NORM = loadFile(os.path.join(os.path.dirname(os.path.abspath(__file__)), "norm_ms.dn.py"),
                "benchmark.metrics.norm_ms__dn").NORM


def read(run):
    if run.trace is None:
        return None
    t = sum(e - s for n, s, e in run.trace.kernels()
            if not any(p.search(n) for p in (trace.LIBRARY, trace.PORT, NOT_ELEMENTWISE, NORM)))
    return perItemMs(run, t)
