"""Host ms an output frame in the device synchronisations after the steps (the program's moe.sync spans)."""

from benchmark.harness.spans import syncMs


def read(run):
    return syncMs(run)
