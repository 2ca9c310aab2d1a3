"""Host ms an output frame in the output steps after the copy to the host (the program's moe.step.toOutput, .Channel and .toBuffer spans)."""

from benchmark.harness.spans import outputHostMs


def read(run):
    return outputHostMs(run)
