"""RGB restoration models.  Ported so far: AODnet (dehaze).

RRDBNet (Real-ESRGAN) and RealBasicVSR's ImageCleaning wait for their
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class AODNet(nn.Module):
    """Tiny dehaze net with a K-estimation output: (B, H, W, 3) ->
    (B, H, W, 3), ``relu(k * x - k + 1)``, not clipped to [0, 1].
    Keys ``conv1``-``conv5``; the input is normalised to [-1, 1] by the
    registry entry's ``prepare``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 3, 1)
        self.conv2 = nn.Conv2d(3, 3, 3, padding=1)
        self.conv3 = nn.Conv2d(6, 3, 5, padding=2)
        self.conv4 = nn.Conv2d(6, 3, 7, padding=3)
        self.conv5 = nn.Conv2d(12, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x1 = F.relu(self.conv1(x))
        x2 = F.relu(self.conv2(x1))
        x3 = F.relu(self.conv3(torch.cat([x1, x2], 1)))
        x4 = F.relu(self.conv4(torch.cat([x2, x3], 1)))
        k = F.relu(self.conv5(torch.cat([x1, x2, x3, x4], 1)))
        return F.relu(k * x - k + 1.0).permute(0, 2, 3, 1)


aodNet = AODNet
