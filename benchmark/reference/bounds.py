"""Peaks of the card and the least time of the port's kernels K1 and K2
on the work an input needs.

Frozen copies from ``chip_smoke.py`` (the port's smoke script): the peaks
from its line 223, ``upBound`` from its lines 336-344, ``warpBound`` from
its lines 998-1007 with the per-value and per-pixel operation counts of
its line 255.  The copies are re-based: they take the sizes the input
needs (the image's own pixels, the clip's own frame size), not the rows
or tensors the port happened to run, so a tiler that pads less reads as
a higher share.
"""

from __future__ import annotations

# H100 SXM dense peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
WARP_FLOP_PER_VALUE, WARP_FLOP_PER_PX = 9, 12  # warp.cu: the blend per channel; coordinates and weights
ITEM = {"bfloat16": 2, "float32": 4}


def upBound(M: int, c: int, nUps: int, cout: int, itemSize: int, peakFlops: float) -> float:
    """Least seconds for the fused up heads (K1) on ``M`` rows of ``c``
    channels: both branches' ``nUps`` up stages and heads, each input read
    once, the output written once, against the peak rate for the type."""
    S = 4**nUps
    macs = M * 2 * sum(4**k for k in range(1, nUps + 1)) * c * c + M * S * 2 * c * cout
    weights = 2 * nUps * 4 * c * c * itemSize + 2 * nUps * 5 * c * 4 + 2 * cout * (c + 1) * 4
    nbytes = 2 * M * c * itemSize + M * S * cout * itemSize + weights
    return max(2 * macs / peakFlops, nbytes / PEAK_BYTES)


def warpBound(h: float, w: float, c: int, imageItem: int, flowItem: int) -> float:
    """Least seconds for one warp (K2) of an (h, w, c) image by an (h, w, 2)
    flow: the image read once, the flow read once, the output written
    once, against the fp32 CUDA-core rate for its operations."""
    nbytes = 2 * h * w * c * imageItem + h * w * 2 * flowItem
    ops = h * w * (WARP_FLOP_PER_VALUE * c + WARP_FLOP_PER_PX)
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32_FLOPS)


def k1ImageBound(h: int, w: int, planes: int, nf: int, nUps: int, dtype: str) -> float:
    """K1's least seconds for an image: one row per low-resolution pixel
    of each plane (``planes`` x h x w rows), not the tiles' padded rows."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    return upBound(planes * h * w, nf, nUps, 1, ITEM[dtype], peak)


def k2FrameBound(h: int, w: int, widths, dtype: str) -> float:
    """K2's least seconds for one interpolated frame of IFRNet at time
    steps k = 1: two warps (one per input frame) at each decoder level on
    the encoder features at 1/8, 1/4 and 1/2 of the frame (``widths`` are
    the encoder's, finest first), and two of the frames themselves (fp32)
    at full size; flows in the compute type.  Sizes are the frame's own,
    h w / 4^l pixels at level l."""
    item = ITEM[dtype]
    t = 2 * warpBound(h, w, 3, ITEM["float32"], item)
    for level in (1, 2, 3):
        s = 2**level
        t += 2 * warpBound(h / s, w / s, widths[level - 1], item, item)
    return t
