"""NAFNet denoise/deblur U-Net (reference ``python/NAFNet.py``; JAX
``models/nafnet.py``) as an ``nn.Module`` with the checkpoint's keys.

The reference nests ``UNetLayer`` modules but keeps them flat in
``self.layers``: ``layers.{i}`` (i < L) holds the encoder blocks, the 2x2
stride-2 ``down`` conv, the ``up`` 1x1 conv (then a pixel shuffle) and the
decoder blocks at width ``width << i``; ``layers.{L}`` is the middle block
stack.  Widths (Chen et al., ECCV 2022): a block at c has ``conv1`` c -> 2c,
a depthwise 3x3 ``conv2``, ``conv3`` c -> c, ``sca.1`` c -> c, ``conv4``
c -> 2c, ``conv5`` c -> c, all with bias; ``up.0`` 2c -> 4c without bias.
H and W must be multiples of 2^L (the registry's tiles align to 16).

The forward pass has three stages (``NAFNet.stages``): the encoder
(``intro``, the encoder blocks and the downs), the middle blocks, and the
decoder (the ups, the skips, the decoder blocks and ``ending``).  Each
model call (a chunk of tiles) records one profiler span a stage while one
records (``progress.span``): ``moe.nafnet.encoder``, ``moe.nafnet.middle``
and ``moe.nafnet.decoder``.  ``engine/executor.ModelExec`` replays the
stages as CUDA graphs for a full chunk on the card.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from moephoto_tpu_torch.models.api import LayerNorm2d, globalAvgPool
from moephoto_tpu_torch.progress import span


class NAFBlock(nn.Module):
    """LN -> 1x1 -> depthwise 3x3 -> SimpleGate -> SCA -> 1x1, added through
    ``beta``; then LN -> 1x1 -> SimpleGate -> 1x1, added through ``gamma``
    (JAX ``_nafBlock``).  Runs on NCHW."""

    def __init__(self, c: int, dwExpand: int = 2, ffnExpand: int = 2):
        super().__init__()
        dw, ffn = c * dwExpand, c * ffnExpand
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1, y2 = self.conv2(self.conv1(self.norm1(x))).chunk(2, 1)
        y = y1 * y2  # SimpleGate
        y = self.conv3(y * self.sca[1](globalAvgPool(y)))
        z = x + y * self.beta.to(x.dtype)
        y1, y2 = self.conv4(self.norm2(z)).chunk(2, 1)
        return z + self.conv5(y1 * y2) * self.gamma.to(x.dtype)


class UNetLayer(nn.Module):
    """One level of the U-Net at width c: ``encoder`` blocks, ``down`` to 2c
    at half the size, (the inner levels), ``up`` back to c, the skip added,
    ``decoder`` blocks."""

    def __init__(self, c: int, nEnc: int, nDec: int):
        super().__init__()
        self.encoder = nn.Sequential(*[NAFBlock(c) for _ in range(nEnc)])
        self.down = nn.Conv2d(c, 2 * c, 2, stride=2)
        self.up = nn.Sequential(nn.Conv2d(2 * c, 4 * c, 1, bias=False), nn.PixelShuffle(2))
        self.decoder = nn.Sequential(*[NAFBlock(c) for _ in range(nDec)])


class NAFNet(nn.Module):
    """(B, H, W, 3) -> (B, H, W, 3): ``intro`` 3 -> width, the U-Net,
    ``ending`` width -> 3, plus the input.  ``decBlkNums`` lists the decoder
    counts from the deepest level out, as the reference's ``dec_blk_nums``."""

    def __init__(self, width: int = 16, middleBlkNum: int = 1, encBlkNums: Sequence[int] = (),
                 decBlkNums: Sequence[int] = ()):
        super().__init__()
        L = len(encBlkNums)
        self.intro = nn.Conv2d(3, width, 3, padding=1)
        self.ending = nn.Conv2d(width, 3, 3, padding=1)
        layers = [UNetLayer(width << i, encBlkNums[i], decBlkNums[L - 1 - i]) for i in range(L)]
        layers.append(nn.Sequential(*[NAFBlock(width << L) for _ in range(middleBlkNum)]))
        self.layers = nn.ModuleList(layers)

    def stages(self):
        """The forward pass as (span name, function) pairs, each function
        taking the result of the one before: the (B, H, W, 3) input, then
        (features, skips, the NCHW input) twice, then the output."""
        return (("moe.nafnet.encoder", self._encode), ("moe.nafnet.middle", self._middle),
                ("moe.nafnet.decoder", self._decode))

    def _encode(self, inp: torch.Tensor):
        x = inp.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        f, skips = self.intro(x), []
        for layer in self.layers[:-1]:
            f = layer.encoder(f)
            skips.append(f)
            f = layer.down(f)
        return f, skips, x

    def _middle(self, state):
        f, skips, x = state
        return self.layers[-1](f), skips, x

    def _decode(self, state) -> torch.Tensor:
        f, skips, x = state
        for layer, skip in zip(reversed(self.layers[:-1]), reversed(skips)):
            f = layer.decoder(layer.up(f) + skip)
        return (self.ending(f) + x).permute(0, 2, 3, 1)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        state = inp
        for name, fn in self.stages():
            with span(name):
                state = fn(state)
        return state


# registry configurations (JAX nafnet.py:88-91)
nafNetSIDD32 = functools.partial(NAFNet, 32, 12, (2, 2, 4, 8), (2, 2, 2, 2))
nafNetSIDD64 = functools.partial(NAFNet, 64, 12, (2, 2, 4, 8), (2, 2, 2, 2))
nafNetGoPro32 = functools.partial(NAFNet, 32, 1, (1, 1, 1, 28), (1, 1, 1, 1))
nafNetGoPro64 = functools.partial(NAFNet, 64, 1, (1, 1, 1, 28), (1, 1, 1, 1))
