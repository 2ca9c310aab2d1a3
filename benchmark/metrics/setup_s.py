"""Seconds from the start of the run to the start of the window: imports,
the card's context, the kernels' build or load, weights and traffic made
from the seed, the chain compiled and warmed."""


def read(run):
    return run.setup_s
