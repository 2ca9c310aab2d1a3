"""Percent: K2's least time for the warps the window's output frames need (SpyNet's level warps and the two propagation warps, at the clip's own size; reference/vsrwork.py) over K2's device time."""

from benchmark.harness import trace
from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k2", trace.K2)
