"""Percent: K1's least time for the up heads of the window's images (one row per low-resolution pixel of each plane, reference/bounds.py) over K1's device time."""

from benchmark.harness import trace
from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k1", trace.K1)
