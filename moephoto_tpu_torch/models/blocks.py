"""Shared building blocks (state-dict keys as in the reference)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.models.api import ScaleLayer, globalAvgPool, prelu


class FRM(nn.Module):
    """Feature recalibration (SE) module: gap -> 1x1 conv -> relu ->
    1x1 conv -> sigmoid -> channel scale.  Keys ``conv_du.0/2``."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.conv_du = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=True),
            nn.ReLU(),
            nn.Conv2d(hidden, channels, 1, bias=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return x * torch.sigmoid(self.conv_du(globalAvgPool(x)))


class _ARSBBody(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.relu = nn.PReLU()
        self.conv_2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.scale = ScaleLayer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale(self.conv_2(prelu(self.conv_1(x), self.relu.weight)))


class ARSB(nn.Sequential):
    """Automatic residual scaling block (JAX ``arsb``): conv -> PReLU ->
    conv -> learned scalar, plus the input.  The reference's Residual
    wrapper registers its body as module ``0``, so the keys are
    ``0.conv_1/relu/conv_2`` and ``0.scale.scale``.  Runs on NCHW."""

    def __init__(self, c: int):
        super().__init__(_ARSBBody(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self[0](x)


class UpsampleBlock(nn.Sequential):
    """conv 3x3 to r^2 c -> PixelShuffle(r) -> PReLU (JAX
    ``upsampleBlock``); keys ``0`` and ``2``.  Runs on NCHW."""

    def __init__(self, c: int, r: int):
        super().__init__(nn.Conv2d(c, c * r * r, 3, padding=1), nn.PixelShuffle(r), nn.PReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(self[1](self[0](x)), self[2].weight)


class ResidualBlockNoBN(nn.Module):
    """conv -> relu -> conv, plus the input (reference models.py:439-458,
    JAX ``residualBlockNoBN``).  Keys ``conv1``, ``conv2``."""

    def __init__(self, c: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return x + self.conv2(F.relu(self.conv1(x)))


class ConvResidualBlocks(nn.Sequential):
    """conv 3x3 -> lrelu(0.1) -> N ResidualBlockNoBN (reference
    videoSR.py:309-311, JAX ``residualBlocksWithInputConv``); keys ``0.*``
    and ``2.{i}.*``.  Runs on NCHW."""

    def __init__(self, cin: int, c: int = 64, numBlocks: int = 30):
        super().__init__(nn.Conv2d(cin, c, 3, 1, 1), nn.LeakyReLU(0.1),
                         nn.Sequential(*[ResidualBlockNoBN(c) for _ in range(numBlocks)]))
