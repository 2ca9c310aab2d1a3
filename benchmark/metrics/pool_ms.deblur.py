"""Device ms an image in the global means of MPRNet's channel attention (models/api.globalAvgPool: the mean over H and W of each channel, accumulated in fp32, which PyTorch runs as a reduce_kernel of MeanOps)."""

import re

from benchmark.harness.readers import perItemMs

MEAN = re.compile(r"reduce_kernel.*MeanOps")


def read(run):
    return None if run.trace is None else perItemMs(run, run.trace.seconds(MEAN))
