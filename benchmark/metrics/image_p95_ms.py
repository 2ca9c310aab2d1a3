"""95th percentile of the time of every image of the window, from the request to its 8-bit result, in ms."""

from benchmark.harness.cell import p95


def read(run):
    return p95([(i.t1 - i.t0) * 1e3 for i in run.window.items]) if len(run.window.items) >= 20 else None
