"""Percent of the card's bf16 peak: the FLOPs MPRNet needs for the window's images, untiled at their own size (reference/deblurwork.py), over the window's wall time."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
