"""Shared building blocks (state-dict keys as in the reference)."""

from __future__ import annotations

import torch
from torch import nn

from moephoto_tpu_torch.models.api import globalAvgPool


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
