"""Device kernels an image, from the profiler's trace."""

from benchmark.harness.readers import launches


def read(run):
    return launches(run)
