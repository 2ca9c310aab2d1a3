"""Device ms an image in the kernels of NAFNet's LayerNorm2d (F.layer_norm over the channels of the channels-last view)."""

import re

from benchmark.harness.readers import perItemMs

# PyTorch's layer-norm forward: vectorized_layer_norm_kernel, or RowwiseMomentsCUDAKernel then
# LayerNormForwardCUDAKernel where the rows do not vectorise
NORM = re.compile(r"layer_norm|LayerNorm|RowwiseMoments")


def read(run):
    return None if run.trace is None else perItemMs(run, run.trace.seconds(NORM))
