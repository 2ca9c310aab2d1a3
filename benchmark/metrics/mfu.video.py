"""Percent of the card's bf16 peak: the FLOPs IFRNet-M needs for the window's interpolated frames (reference/flops.py) over the window's wall time."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
