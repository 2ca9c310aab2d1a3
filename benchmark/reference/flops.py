"""Floating-point operations an input needs, counted on the plain
references on the meta device (convolutions and products; a multiply-add
is two operations; ``torch.utils.flop_counter`` counts them from shapes).

The work is the input's own: an image at its own size, untiled; a clip
frame at its size padded to the model's alignment, scaled back to the
frame's own pixels.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import ifrnet, lite


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _liteMeta(upscale: int) -> lite.MoeNetLite2:
    return lite.MoeNetLite2(upscale).to("meta")


@functools.lru_cache(maxsize=None)
def liteImageFlops(h: int, w: int, planes: int, upscale: int) -> int:
    """MoeNet_lite2 over ``planes`` planes of an h x w image."""
    x = torch.empty((planes, 1, h, w), device="meta")
    return _count(lambda: _liteMeta(upscale)(x))


@functools.lru_cache(maxsize=None)
def _ifrnetMeta() -> ifrnet.IFRNetM:
    return ifrnet.IFRNetM().to("meta")


@functools.lru_cache(maxsize=None)
def ifrnetFrameFlops(h: int, w: int) -> float:
    """IFRNet-M per interpolated frame (k = 1): one frame's encoding (each
    input frame is encoded once and serves two pairs) and one pair's
    decoding, on the aligned frame, times the frame's share of it."""
    model = _ifrnetMeta()
    H, W = -(-h // ifrnet.ALIGN) * ifrnet.ALIGN, -(-w // ifrnet.ALIGN) * ifrnet.ALIGN
    one = torch.empty((1, 3, H, W), device="meta")
    enc = _count(lambda: model.encoder(one))
    f = model.encoder(one)
    dec = _count(lambda: model.interpolate(f, f, one, one, one[:, :1, :1, :1], one[:, :1, :1, :1], 0.5))
    return (enc + dec) * (h * w) / (H * W)
