"""RGB restoration models: AODnet (dehaze), RRDBNet (Real-ESRGAN) and
RealBasicVSR's ImageCleaning, as ``nn.Module``s with the checkpoints' keys
(JAX ``models/restore.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.models.api import interpolateScale, onNHWC, pixelUnshuffle
from moephoto_tpu_torch.models.blocks import ConvResidualBlocks


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


class RDB(nn.Module):
    """Residual dense block: five 3x3 convs on the concatenation of the
    input and every earlier output (c + i g -> g, the last -> c), LeakyReLU
    0.2 after the first four; 0.2 times the last, plus the input.  Keys
    ``conv.{0..4}``."""

    def __init__(self, c: int = 64, g: int = 32):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(c + i * g, g if i < 4 else c, 3, padding=1) for i in range(5)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i, conv in enumerate(self.conv):
            t = conv(torch.cat(feats, 1) if i else x)
            feats.append(F.leaky_relu(t, 0.2) if i < 4 else t)
        return t * 0.2 + x


class RRDB(nn.Module):
    """Three RDBs (``rdb1``-``rdb3``); 0.2 times their result, plus the input."""

    def __init__(self, c: int = 64, g: int = 32):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = RDB(c, g), RDB(c, g), RDB(c, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """Real-ESRGAN's generator, (B, H, W, 3) -> (B, H scale, W scale, 3):
    pixel-unshuffle by 4 / ``scale`` (so x2 runs the x4 body at half the
    size), ``conv_first``, ``numBlock`` RRDBs and ``conv_body`` added to the
    features, two nearest x2 upsamples each followed by a conv and
    LeakyReLU 0.2, ``conv_hr``, LeakyReLU, ``conv_last``.  64 features,
    growth 32, every conv with bias (xinntao/Real-ESRGAN)."""

    def __init__(self, scale: int = 4, numBlock: int = 23, nf: int = 64, gc: int = 32):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"RRDBNet scale {scale} not in (1, 2, 4)")
        self.unshuffle = 4 // scale
        conv = lambda cin, cout: nn.Conv2d(cin, cout, 3, padding=1)
        self.conv_first = conv(3 * self.unshuffle ** 2, nf)
        self.body = nn.Sequential(*[RRDB(nf, gc) for _ in range(numBlock)])
        self.conv_body = conv(nf, nf)
        self.conv_up1 = conv(nf, nf)
        self.conv_up2 = conv(nf, nf)
        self.conv_hr = conv(nf, nf)
        self.conv_last = conv(nf, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv_first(pixelUnshuffle(x, self.unshuffle).permute(0, 3, 1, 2))
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = F.leaky_relu(conv(onNHWC(interpolateScale, feat, 2, "nearest")), 0.2)
        return self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2)).permute(0, 2, 3, 1)


rrdbNetX4 = functools.partial(RRDBNet, 4, 23)
rrdbNetX2 = functools.partial(RRDBNet, 2, 23)
rrdbNetX4Anime = functools.partial(RRDBNet, 4, 6)


class ImageCleaning(nn.Sequential):
    """RealBasicVSR's image-cleaning prefilter: conv 3 -> 64, LeakyReLU 0.1
    and 20 residual blocks (key ``0``), a conv 64 -> 3 (key ``1``), plus the
    input.  (B, H, W, 3) -> (B, H, W, 3)."""

    def __init__(self, c: int = 64, numBlocks: int = 20):
        super().__init__(ConvResidualBlocks(3, c, numBlocks), nn.Conv2d(c, 3, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        return (self[1](self[0](x)) + x).permute(0, 2, 3, 1)


imageCleaning = ImageCleaning
