"""Device ms an output frame in kernels that are neither cuDNN/cuBLAS convolutions and products nor the port's own kernels nor copies: the passes between IconVSR's convolutions."""

from benchmark.harness.readers import elementwiseMs


def read(run):
    return elementwiseMs(run)
