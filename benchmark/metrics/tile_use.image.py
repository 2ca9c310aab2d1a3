"""Percent: tiles the chunks needed over tiles the model ran (the program's moe.count.tiles_needed and tiles_run counters)."""

from benchmark.harness.spans import tileUse


def read(run):
    return tileUse(run)
