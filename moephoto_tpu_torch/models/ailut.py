"""AiLUT adaptive-interval 3D LUT retouching (AdaInt, CVPR 2022) as an
``nn.Module``, with the JAX package's state-dict keys.

The backbone (TPAMI 5-conv or ResNet-18) sees a fixed 256 or 224 px
bilinear resize of the image and gives the codes; three linears turn the
codes into the image's LUT and its adaptive vertices; the LUT is applied
to the full-resolution image by :func:`ops.lut.ailutTransform`, the CUDA
kernel on the card.

The backbone and the linears run in full fp32 whatever the process-wide
TF32 flags say (:func:`models.api.fullFp32`): a small perturbation of the
codes moves the LUT's slopes, and the JAX package records that running
them at reduced precision cost about 2 dB on the sun -> AOD -> AiLUT
chain, so it pins them to its highest precision too.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.models.api import fullFp32, resizeBilinear
from moephoto_tpu_torch.ops.lut import ailutTransform

TPAMI_WIDTHS = (16, 32, 64, 128, 128)


def _tpamiBlock(cin: int, cout: int, norm: bool) -> nn.Sequential:
    # keys .0 (conv) and .2 (InstanceNorm), as Sequential(conv, LeakyReLU, IN)
    layers = [nn.Conv2d(cin, cout, 3, stride=2, padding=1), nn.LeakyReLU(0.2)]
    if norm:
        layers.append(nn.InstanceNorm2d(cout, affine=True))
    return nn.Sequential(*layers)


class TPAMIBackbone(nn.Sequential):
    """5 stride-2 conv + LeakyReLU(0.2) blocks, InstanceNorm on the first
    four, then a 2x2 adaptive average pool: 256 px -> 128 * 4 codes."""

    inputSize = 256

    def __init__(self):
        cins = (3,) + TPAMI_WIDTHS[:-1]
        super().__init__(*[_tpamiBlock(ci, co, i < 4) for i, (ci, co) in enumerate(zip(cins, TPAMI_WIDTHS))])
        self.outChannels = TPAMI_WIDTHS[-1] * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return F.adaptive_avg_pool2d(super().forward(x), 2)


class BasicBlock(nn.Module):
    """ResNet basic block; eval-mode BatchNorm with the running stats."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Res18Backbone(nn.Module):
    """ResNet-18 trunk without its classifier: 224 px -> 512 codes."""

    inputSize = 224

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cins, couts, strides = (64, 64, 128, 256), (64, 128, 256, 512), (1, 2, 2, 2)
        for i, (ci, co, s) in enumerate(zip(cins, couts, strides)):
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(ci, co, s), BasicBlock(co, co, 1)))
        self.outChannels = 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3), keepdim=True)


class _Generator(nn.Module):
    def __init__(self, nFeats: int, nRanks: int, nVertices: int):
        super().__init__()
        self.weights_generator = nn.Linear(nFeats, nRanks)
        self.basis_luts_bank = nn.Linear(nRanks, 3 * nVertices**3, bias=False)


class _AdaInt(nn.Module):
    def __init__(self, nFeats: int, nVertices: int):
        super().__init__()
        self.intervals_generator = nn.Linear(nFeats, 3 * (nVertices - 1))


class AiLUT(nn.Module):
    """AiLUT: (B, H, W, 3) fp32 -> (B, H, W, 3).

    Keys ``backbone.*``, ``lut_generator.weights_generator``,
    ``lut_generator.basis_luts_bank`` (no bias) and
    ``adaint.intervals_generator``."""

    def __init__(self, nRanks: int = 3, nVertices: int = 33, backbone: str = "tpami"):
        super().__init__()
        if backbone not in ("tpami", "res18"):
            raise ValueError(f"AiLUT backbone {backbone!r} not in ('tpami', 'res18')")
        self.nVertices = nVertices
        self.backbone = TPAMIBackbone() if backbone == "tpami" else Res18Backbone()
        nFeats = self.backbone.outChannels
        self.lut_generator = _Generator(nFeats, nRanks, nVertices)
        self.adaint = _AdaInt(nFeats, nVertices)

    def generate(self, imgs: torch.Tensor):
        """Codes (B, nFeats), LUT (B, 3, D, D, D) and vertices (B, 3, D) of
        an NHWC batch, in full fp32."""
        b, D = imgs.shape[0], self.nVertices
        size = self.backbone.inputSize
        with fullFp32():
            x = resizeBilinear(imgs.float(), size, size).permute(0, 3, 1, 2)
            codes = self.backbone(x).reshape(b, -1)  # NCHW flattens in (C, H, W) order
            weights = self.lut_generator.weights_generator(codes)
            luts = self.lut_generator.basis_luts_bank(weights).reshape(b, 3, D, D, D)
            intervals = self.adaint.intervals_generator(codes).reshape(b, 3, D - 1)
        vertices = F.pad(torch.softmax(intervals, dim=-1).cumsum(dim=-1), (1, 0))
        return codes, luts.contiguous(), vertices.contiguous()

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        _, luts, vertices = self.generate(imgs)
        return ailutTransform(imgs.contiguous(), luts, vertices)


ailutTPAMI = functools.partial(AiLUT, 3, 33, "tpami")
ailutRes18 = functools.partial(AiLUT, 5, 33, "res18")
