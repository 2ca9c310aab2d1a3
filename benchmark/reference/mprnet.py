"""Plain MPRNet (Zamir, Arora, Khan, Hayat, Khan, Yang and Shao,
"Multi-Stage Progressive Image Restoration", CVPR 2021; swz30/MPRNet
``Deblurring/MPRNet.py``), NCHW in fp32, and the deblur step's image chain
around it: MoePhoto's RGB tiler and the 8-bit output.

The network, widths n (``n_feat``), s (``scale_unetfeats``) and o
(``scale_orsnetfeats``), every conv without bias, ``num_cab`` CABs an ORB:

    CAB(x)      = x + CA(conv3x3(PReLU(conv3x3(x))))
    CA(t)       = t * sigmoid(conv1x1(ReLU(conv1x1(mean_HW(t)))))   reduction 4
    Down(t)     = conv1x1(bilinear 0.5x (t))       c -> c + s, align_corners False
    Up(t)       = conv1x1(bilinear 2x (t))         c + s -> c
    Encoder     levels at n, n + s, n + 2s: two CABs each, Down between;
                in stage 2 each level adds conv1x1(enc1_l) + conv1x1(dec1_l)
    Decoder     dec_3 = CABs(enc_3); dec_l = CABs(Up(dec_{l+1}) + CAB(enc_l))
    SAM(f, x)   img = conv1x1(f) + x; f' = conv1x1(f) * sigmoid(conv1x1(img)) + f
    ORB(t)      = t + conv3x3(CABs(t))             at n + o
    ORSNet(t)   three ORBs, each followed by t += conv1x1(Up^l(enc2_l)) + conv1x1(Up^l(dec2_l))

    stage 1     the four quadrants apart: enc1 = Encoder(CAB(conv3x3(q)));
                each half's decoder on its two quadrants' features joined
                along W; SAM on the half's image
    stage 2     each half apart: Encoder(concat12(shallow2(half), SAM features))
                with stage 1's features; decoder on the halves' features
                joined along H; SAM on the image
    stage 3     t = concat23(shallow3(x), SAM features); y = tail(ORSNet(t)) + x

The state-dict keys are MoePhoto's (``python/MPRNet.py``; the port loads
the checkpoint with ``strict=True``): a CAB is ``0``-``3`` (conv, PReLU,
conv, CA as ``conv_du.0`` and ``conv_du.2``); ``shallow_feat.{0,1,2}``,
``encoder.{0,1}`` (``encoder.{l}.{0,1,2}``: the Down, or nothing at level
0, and two CABs; ``csff_enc/dec.{l}``), ``encoder.2`` the ORSNet
(``orb.{i}``, ``conv_enc/dec.{i}``: i Ups and the 1x1 conv),
``decoder.{0,1}`` (``decoder.{l}``, ``skip_attn.{l}``, ``up.{l}.up.1``),
``sam.{0,1}``, ``concat.{0,1}``, ``tail``.

Departures from ``Deblurring/MPRNet.py``, each pinned by a test
(``tests/test_torch_mprnet_reference.py``):

- The channel attention and the quadrant split act on each tile, not on
  the image: MoePhoto runs the model on halo tiles of 256 (the registry's
  ``TileSpec(256, 8, 8, 1, 2)``), so the tiling is part of the function
  computed (``deblurImage``).
- The image is reflect-padded at the bottom and right to the tiler's
  extent (a multiple of 8 at least); the published test script pads
  nothing and needs the image's own sides to split.
- Only the last stage's image is returned, clamped to [0, 1]; the
  published model returns all three stages' images, unclamped.
- Each CAB holds its own PReLU slope under its own key; the published
  model shares one ``act`` among all of them (its checkpoint lists the
  shared slope under every CAB's key).  The benchmark's draw gives every
  slope one value, so the function is the published one.

Every convolution is a ``layers.QConv2d``, so that the benchmark's weight
draw reaches them and the correctness check's control quantises them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import lite
from benchmark.reference.layers import QConv2d
from benchmark.reference.nafnet import tiledRGB

REDUCTION = 4


def conv(cin: int, cout: int, k: int) -> QConv2d:
    return QConv2d(cin, cout, k, padding=k // 2, bias=False)


class CALayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_du = nn.Sequential(conv(c, c // REDUCTION, 1), nn.ReLU(), conv(c // REDUCTION, c, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(F.adaptive_avg_pool2d(x, 1))


class CAB(nn.Sequential):
    def __init__(self, c: int):
        super().__init__(conv(c, c, 3), nn.PReLU(), conv(c, c, 3), CALayer(c))

    def forward(self, x):
        return super().forward(x) + x


def bilinear(x, factor: float):
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


class Resample(nn.Sequential):
    """Down (0.5) or Up (2): the bilinear resize (module ``0``), then a 1x1
    conv (``1``)."""

    def __init__(self, cin: int, cout: int, factor: float):
        super().__init__(nn.Identity(), conv(cin, cout, 1))
        self.factor = factor

    def forward(self, x):
        return self[1](bilinear(x, self.factor))


class Encoder(nn.Module):
    def __init__(self, n: int, s: int, csff: bool):
        super().__init__()
        w = [n, n + s, n + 2 * s]
        self.encoder = nn.ModuleList([nn.Sequential(nn.Identity() if l == 0 else Resample(w[l - 1], w[l], 0.5),
                                                    CAB(w[l]), CAB(w[l])) for l in range(3)])
        if csff:
            self.csff_enc = nn.ModuleList([conv(c, c, 1) for c in w])
            self.csff_dec = nn.ModuleList([conv(c, c, 1) for c in w])

    def forward(self, x, encOuts=None, decOuts=None) -> List[torch.Tensor]:
        outs = []
        for l, level in enumerate(self.encoder):
            x = level(x)
            if encOuts is not None:
                x = x + self.csff_enc[l](encOuts[l]) + self.csff_dec[l](decOuts[l])
            outs.append(x)
        return outs


class SkipUp(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = Resample(cin, cout, 2.0)


class Decoder(nn.Module):
    def __init__(self, n: int, s: int):
        super().__init__()
        w = [n, n + s, n + 2 * s]
        self.decoder = nn.ModuleList([nn.Sequential(CAB(c), CAB(c)) for c in w])
        self.skip_attn = nn.ModuleList([CAB(w[0]), CAB(w[1])])
        self.up = nn.ModuleList([SkipUp(w[1], w[0]), SkipUp(w[2], w[1])])

    def forward(self, outs):
        enc1, enc2, enc3 = outs
        dec3 = self.decoder[2](enc3)
        dec2 = self.decoder[1](self.up[1].up(dec3) + self.skip_attn[1](enc2))
        dec1 = self.decoder[0](self.up[0].up(dec2) + self.skip_attn[0](enc1))
        return [dec1, dec2, dec3]


class SAM(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = conv(n, n, 1), conv(n, 3, 1), conv(3, n, 1)

    def forward(self, x, xImg):
        img = self.conv2(x) + xImg
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class ORSNet(nn.Module):
    def __init__(self, n: int, s: int, o: int, numCab: int):
        super().__init__()
        w = n + o
        self.orb = nn.ModuleList([nn.Sequential(*[CAB(w) for _ in range(numCab)], conv(w, w, 3)) for _ in range(3)])

        def fuse(i):  # level i's features: i Ups down to width n, then n -> n + o
            ups = [Resample(n + (i - j) * s, n + (i - j - 1) * s, 2.0) for j in range(i)]
            return nn.Sequential(*ups, conv(n, w, 1))

        self.conv_enc = nn.ModuleList([fuse(i) for i in range(3)])
        self.conv_dec = nn.ModuleList([fuse(i) for i in range(3)])

    def forward(self, x, encOuts, decOuts):
        for i in range(3):
            x = self.orb[i](x) + x
            x = x + self.conv_enc[i](encOuts[i]) + self.conv_dec[i](decOuts[i])
        return x


class MPRNet(nn.Module):
    """(N, 3, H, W) -> (N, 3, H, W) in [0, 1], H and W multiples of 8."""

    def __init__(self, n: int = 96, s: int = 48, o: int = 32, numCab: int = 8):
        super().__init__()
        self.shallow_feat = nn.ModuleList([nn.Sequential(conv(3, n, 3), CAB(n)) for _ in range(3)])
        self.encoder = nn.ModuleList([Encoder(n, s, False), Encoder(n, s, True), ORSNet(n, s, o, numCab)])
        self.decoder = nn.ModuleList([Decoder(n, s), Decoder(n, s)])
        self.sam = nn.ModuleList([SAM(n), SAM(n)])
        self.concat = nn.ModuleList([conv(2 * n, n, 3), conv(2 * n, n + o, 3)])
        self.tail = conv(n + o, 3, 3)

    def forward(self, x3):
        H, W = x3.shape[2], x3.shape[3]
        x2top, x2bot = x3[:, :, : H // 2], x3[:, :, H // 2 :]
        quads = [x2top[..., : W // 2], x2top[..., W // 2 :], x2bot[..., : W // 2], x2bot[..., W // 2 :]]

        # stage 1: each quadrant encoded alone, each half decoded alone
        ltop, rtop, lbot, rbot = (self.encoder[0](self.shallow_feat[0](q)) for q in quads)
        feat1Top = [torch.cat((k, v), 3) for k, v in zip(ltop, rtop)]
        feat1Bot = [torch.cat((k, v), 3) for k, v in zip(lbot, rbot)]
        res1Top, res1Bot = self.decoder[0](feat1Top), self.decoder[0](feat1Bot)
        samTop, _ = self.sam[0](res1Top[0], x2top)
        samBot, _ = self.sam[0](res1Bot[0], x2bot)

        # stage 2: each half encoded alone, the image decoded
        catTop = self.concat[0](torch.cat([self.shallow_feat[1](x2top), samTop], 1))
        catBot = self.concat[0](torch.cat([self.shallow_feat[1](x2bot), samBot], 1))
        feat2Top = self.encoder[1](catTop, feat1Top, res1Top)
        feat2Bot = self.encoder[1](catBot, feat1Bot, res1Bot)
        feat2 = [torch.cat((k, v), 2) for k, v in zip(feat2Top, feat2Bot)]
        res2 = self.decoder[1](feat2)
        sam3, _ = self.sam[1](res2[0], x3)

        # stage 3: the original resolution
        x3cat = self.concat[1](torch.cat([self.shallow_feat[2](x3), sam3], 1))
        return (self.tail(self.encoder[2](x3cat, feat2, res2)) + x3).clamp(0.0, 1.0)


def fromConfig(cfg: dict) -> MPRNet:
    """The configuration file's MPRNet (``benchmark/configs/mprnet_*.json``)."""
    return MPRNet(int(cfg["n_feat"]), int(cfg["scale_unetfeats"]), int(cfg["scale_orsnetfeats"]), int(cfg["num_cab"]))


@torch.no_grad()
def deblurImage(model: MPRNet, image, spec: dict, device) -> torch.Tensor:
    """The deblur step's result for a uint8 (H, W, 3) array, as the program
    computes it: the 8-bit (H, W, 3) output of the tiled model in fp32."""
    x = torch.as_tensor(image).to(device).permute(2, 0, 1).float() / 255.0
    y = tiledRGB(x, model, spec["tile"], spec["pad"], spec["align"], spec["batch"])
    return lite.toOutput8(y).permute(1, 2, 0)
