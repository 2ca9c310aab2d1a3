"""Percent of the card's bf16 peak: the FLOPs MoeNet_lite2 needs for the window's images (reference/flops.py) over the window's wall time."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
