"""Demoire models.  Ported so far: sun_demoire.

moire_obj and moire_screen_gan wait for their slice.
"""

from __future__ import annotations

import torch
from torch import nn

from moephoto_tpu_torch.models.api import prelu

# (cin, cm, cout) of each Down; stride 2 where cin == cm
SUN_DOWNS = ((3, 32, 32), (32, 32, 64), (64, 64, 64), (64, 64, 64), (64, 64, 64))


class Down(nn.Module):
    """conv 3x3 (stride 2 iff cin == cm) -> PReLU -> conv 3x3."""

    def __init__(self, cin: int, cm: int, cout: int):
        super().__init__()
        self.down = nn.Conv2d(cin, cm, 3, stride=2 if cin == cm else 1, padding=1)
        self.relu = nn.PReLU()
        self.convt_R1 = nn.Conv2d(cm, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convt_R1(prelu(self.down(x), self.relu.weight))


def _branch(level: int, c: int) -> nn.Sequential:
    """Level 0: conv 3x3 to RGB -> PReLU.  Level i > 0: i pairs of
    (ConvTranspose 4/2/1, PReLU), then conv 3x3 to RGB."""
    if level == 0:
        return nn.Sequential(nn.Conv2d(c, 3, 3, padding=1), nn.PReLU())
    layers = []
    for _ in range(level):
        layers += [nn.ConvTranspose2d(c, c, 4, stride=2, padding=1), nn.PReLU()]
    return nn.Sequential(*layers, nn.Conv2d(c, 3, 3, padding=1))


class SunDemoire(nn.Module):
    """5-scale downsample with one up branch per scale, summed:
    (B, H, W, 3) -> (B, H, W, 3); H and W multiples of 16.  Keys
    ``downs.{i}.{down,relu,convt_R1}`` and ``branches.{i}.{j}``; the
    ConvTranspose weights are (64, 64, 4, 4), the only 4x4 kernels
    (``registry._sunConvT``)."""

    def __init__(self):
        super().__init__()
        self.downs = nn.ModuleList([Down(*cfg) for cfg in SUN_DOWNS])
        self.branches = nn.ModuleList([_branch(i, cfg[2]) for i, cfg in enumerate(SUN_DOWNS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        total = None
        for down, branch in zip(self.downs, self.branches):
            feat = down(feat)
            b = feat
            for layer in branch:
                b = prelu(b, layer.weight) if isinstance(layer, nn.PReLU) else layer(b)
            total = b if total is None else total + b
        return total.permute(0, 2, 3, 1)


sunDemoire = SunDemoire
