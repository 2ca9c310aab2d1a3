"""Host ms an output frame in the stream graph's scheduling passes outside the steps they run (self time of the program's moe.stream.run spans)."""

from benchmark.harness.spans import streamSelfMs


def read(run):
    return streamSelfMs(run)
