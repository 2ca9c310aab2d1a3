"""Floating-point operations MPRNet needs for an image (convolutions; a
multiply-add is two operations), counted on the plain reference on the
meta device, as ``flops.py`` counts the other models.

The work is the image's own: the whole image, untiled, at its size padded
to the model's alignment of 8 (the quadrants, then two halvings), times
the image's share of the padded pixels.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference import mprnet
from benchmark.reference.flops import _count

ALIGN = 8


@functools.lru_cache(maxsize=None)
def _meta(n: int, s: int, o: int, numCab: int) -> mprnet.MPRNet:
    return mprnet.MPRNet(n, s, o, numCab).to("meta")


@functools.lru_cache(maxsize=None)
def imageFlops(h: int, w: int, n: int = 96, s: int = 48, o: int = 32, numCab: int = 8) -> float:
    """MPRNet over an h x w RGB image."""
    H, W = -(-h // ALIGN) * ALIGN, -(-w // ALIGN) * ALIGN
    x = torch.empty((1, 3, H, W), device="meta")
    return _count(lambda: _meta(n, s, o, numCab)(x)) * (h * w) / (H * W)
