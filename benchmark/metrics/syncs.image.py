"""Device synchronisations an image (the program's moe.sync spans)."""

from benchmark.harness.spans import syncs


def read(run):
    return syncs(run)
