"""Percent of the traced window in which no kernel, copy or set of memory ran on the card."""

from benchmark.harness.readers import idle


def read(run):
    return idle(run)
