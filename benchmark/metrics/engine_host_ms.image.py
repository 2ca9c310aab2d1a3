"""Host ms an image in the tiler's chunks: tile gather, padding, the model call and the blend (the program's moe.engine.chunk spans)."""

from benchmark.harness.spans import engineHostMs


def read(run):
    return engineHostMs(run)
