"""Percent of the card's bf16 peak: the FLOPs IconVSR needs for the window's output frames (reference/vsrwork.py) over the window's wall time."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
