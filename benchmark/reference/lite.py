"""Plain MoeNet_lite2 (opteroncx/MoePhoto ``python/MoeNet_lite2.py``),
NCHW, and the image chain around it: the halo tiler, the per-plane run
and the 8-bit output.

The network (state-dict keys as the published checkpoint's):

    out = PReLU(conv_input(x))                          1x1, 1 -> 48
    f   = LB3(LB2(LB1(conv_input2(out))))               1x1, then 3 LB blocks
    LB(x) = FRM(conv_2(PReLU(conv_1(x)))) + x           3x3 convs, 48 -> 48
    FRM(x) = x * sigmoid(conv(ReLU(conv(mean_hw(x)))))  48 -> 3 -> 48, biased
    up(x) = PReLU(PixelShuffle2(conv1x1(x)))            48 -> 192 -> 48 at 2x
    y   = convt_R1(up(up(f))) + convt_I1(up(up(out)))   two branches for x4

The tiler is a frozen plain copy of the port's halo tiler semantics: the
image is reflect-padded bottom and right so tiles of ``tile`` pixels on
a stride of ``tile - 2 pad`` cover it, each tile runs alone (FRM pools
over the tile, so the tiling is part of the result), and the outputs are
blended by a separable sigmoid window and normalised.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import QConv2d

NF, HIDDEN = 48, 3


class FRM(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.conv_du = nn.Sequential(QConv2d(c, hidden, 1), nn.ReLU(), QConv2d(hidden, c, 1))

    def forward(self, x):
        return x * torch.sigmoid(self.conv_du(x.mean(dim=(2, 3), keepdim=True)))


class LB(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.conv_1 = QConv2d(c, c, 3, padding=1, bias=False)
        self.relu = nn.PReLU()
        self.conv_2 = QConv2d(c, c, 3, padding=1, bias=False)
        self.se = FRM(c, hidden)

    def forward(self, x):
        return self.se(self.conv_2(self.relu(self.conv_1(x)))) + x


def upStage(c: int) -> nn.Sequential:
    return nn.Sequential(QConv2d(c, 4 * c, 1), nn.PixelShuffle(2), nn.PReLU())


class MoeNetLite2(nn.Module):
    """(N, 1, H, W) -> (N, 1, H s, W s) for s = 2 ** nUps."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        nUps = int(upscale).bit_length() - 1
        if 1 << nUps != upscale:
            raise ValueError(f"upscale {upscale} is not a power of 2")
        self.conv_input = QConv2d(1, NF, 1, bias=False)
        self.relu = nn.PReLU()
        self.conv_input2 = QConv2d(NF, NF, 1, bias=False)
        self.convt_F11 = LB(NF, HIDDEN)
        self.convt_F12 = LB(NF, HIDDEN)
        self.convt_F13 = LB(NF, HIDDEN)
        self.ures = nn.Sequential(*[upStage(NF) for _ in range(nUps)])
        self.uim = nn.Sequential(*[upStage(NF) for _ in range(nUps)])
        self.convt_R1 = QConv2d(NF, 1, 1, bias=False)
        self.convt_I1 = QConv2d(NF, 1, 1, bias=False)

    def forward(self, x):
        out = self.relu(self.conv_input(x))
        f = self.convt_F13(self.convt_F12(self.convt_F11(self.conv_input2(out))))
        return self.convt_R1(self.ures(f)) + self.convt_I1(self.uim(out))


# --- the tiler ---------------------------------------------------------------

ceilTo = lambda x, d: -(-int(x) // d) * d


def planAxis(size: int, tile: int, pad: int) -> List[int]:
    stride = tile - 2 * pad
    if size <= tile:
        return [0]
    return [i * stride for i in range(math.ceil((size - 2 * pad) / stride))]


def paddedExtent(size: int, tile: int, pad: int, align: int) -> int:
    if size <= tile:
        return ceilTo(size, align)
    return max(planAxis(size, tile, pad)[-1] + tile, ceilTo(size, align))


def axisWindow(t: int, padSc: int, first: bool, last: bool) -> torch.Tensor:
    """1-D blend weights: an interior edge drops its outer ``padSc // 2``
    pixels and ramps over the next ``2 (padSc - padSc // 2)`` by a sigmoid
    whose two halves of an overlap sum to 1; an image edge keeps weight 1."""
    w = torch.ones(t)
    if padSc == 0:
        return w
    d = padSc // 2
    r = 2 * (padSc - d)
    ramp = torch.sigmoid(((torch.arange(r, dtype=torch.float32) + 0.5) / r - 0.5) * 9.0)
    if not first:
        w[:d] = 0.0
        w[d : d + r] = ramp
    if not last:
        w[t - d :] = 0.0
        w[t - d - r : t - d] = ramp.flip(0)
    return w


def reflectPad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad (C, H, W) at the bottom and right, reflecting again
    while the pad exceeds the extent."""
    while ph > 0 or pw > 0:
        dh, dw = min(ph, x.shape[1] - 1), min(pw, x.shape[2] - 1)
        if dh == 0 and dw == 0:
            return F.pad(x[None], (0, pw, 0, ph), mode="replicate")[0]
        x = F.pad(x[None], (0, dw, 0, dh), mode="reflect")[0]
        ph, pw = ph - dh, pw - dw
    return x


def tiled(img: torch.Tensor, fn: Callable, tile: int, pad: int, align: int, scale: int,
          tilesPerCall: int = 2) -> torch.Tensor:
    """(C, H, W) fp32 -> (C, H s, W s): tiles of every plane through ``fn``
    ((N, 1, th, tw) -> (N, 1, th s, tw s)), ``tilesPerCall`` tiles (all
    their planes) a call, blended on an fp32 canvas."""
    c, h, w = img.shape
    ph, pw = paddedExtent(h, tile, pad, align), paddedExtent(w, tile, pad, align)
    xp = reflectPad(img, ph - h, pw - w)
    ys, xs = planAxis(h, tile, pad), planAxis(w, tile, pad)
    th, tw = min(tile, ph), min(tile, pw)
    padSc = pad * scale
    canvas = torch.zeros((c, ph * scale, pw * scale), dtype=torch.float32, device=img.device)
    weight = torch.zeros((1, ph * scale, pw * scale), dtype=torch.float32, device=img.device)
    places = [(y, x, iy == 0, iy == len(ys) - 1, ix == 0, ix == len(xs) - 1)
              for iy, y in enumerate(ys) for ix, x in enumerate(xs)]
    for s in range(0, len(places), tilesPerCall):
        chunk = places[s : s + tilesPerCall]
        planes = torch.cat([xp[:, y : y + th, x : x + tw] for y, x, *_ in chunk])[:, None]
        outs = fn(planes).reshape(len(chunk), c, th * scale, tw * scale)
        for (y, x, fy, ly, fx, lx), out in zip(chunk, outs):
            win = (axisWindow(th * scale, padSc, fy, ly)[:, None]
                   * axisWindow(tw * scale, padSc, fx, lx)[None, :]).to(img.device)
            oy, ox = y * scale, x * scale
            canvas[:, oy : oy + th * scale, ox : ox + tw * scale] += out.float() * win
            weight[:, oy : oy + th * scale, ox : ox + tw * scale] += win
    return (canvas / weight.clamp_min(1e-8))[:, : h * scale, : w * scale]


def toOutput8(y: torch.Tensor) -> torch.Tensor:
    """Float in [0, 1] -> uint8 as the chain's output step quantises:
    times 256, clipped to [0, 255], truncated."""
    return (y.float() * 256).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def srImage(model: MoeNetLite2, image, spec: dict, device) -> torch.Tensor:
    """The image chain's result for a uint8 (H, W, 3) array: the 8-bit
    (H s, W s, 3) output, every plane through the tiled model in fp32."""
    x = torch.as_tensor(image).to(device).permute(2, 0, 1).float() / 255.0
    y = tiled(x, model, spec["tile"], spec["pad"], spec["align"], spec["scale"])
    return toOutput8(y).permute(1, 2, 0)
