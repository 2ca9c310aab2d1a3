"""Floating-point operations NAFNet needs for an image (convolutions; a
multiply-add is two operations), counted on the plain reference on the
meta device, as ``flops.py`` counts the other models.

The work is the image's own: the whole image, untiled, at its size padded
to the U-Net's alignment, times the image's share of the padded pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from benchmark.reference import nafnet
from benchmark.reference.flops import _count


@functools.lru_cache(maxsize=None)
def _meta(width: int, middle: int, enc: Tuple[int, ...], dec: Tuple[int, ...]) -> nafnet.NAFNet:
    return nafnet.NAFNet(width, middle, enc, dec).to("meta")


@functools.lru_cache(maxsize=None)
def imageFlops(h: int, w: int, width: int = 32, middle: int = 12, enc: Tuple[int, ...] = (2, 2, 4, 8),
               dec: Tuple[int, ...] = (2, 2, 2, 2)) -> float:
    """NAFNet over an h x w RGB image."""
    align = 2 ** len(enc)
    H, W = -(-h // align) * align, -(-w // align) * align
    x = torch.empty((1, 3, H, W), device="meta")
    return _count(lambda: _meta(width, middle, tuple(enc), tuple(dec))(x)) * (h * w) / (H * W)
