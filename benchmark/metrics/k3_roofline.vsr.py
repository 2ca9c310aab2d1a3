"""Percent: K3's least time for the four DCNs of each keyframe clip the window's output frames need, at the clip's own size (reference/vsrwork.py), over K3's device time (the kernels dcnKernel and dcnMmaKernel)."""

import re

from benchmark.harness.readers import roofline

K3 = re.compile(r"dcnKernel|dcnMmaKernel")


def read(run):
    return roofline(run, "k3", K3)
