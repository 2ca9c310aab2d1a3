"""Host ms an output frame inside the program's moe.vsr.* spans (EDVR, SpyNet, the two scans, the upsampler): the Python that issues IconVSR's work, and any wait for the card inside it.  None where the window holds no such span."""

from benchmark.harness.spans import inWindow, perItem, union


def read(run):
    spans = [(s, e) for n, s, e in inWindow(run) or () if n.startswith("moe.vsr.")]
    return perItem(run, union(spans) * 1e3) if spans else None
