"""Plain NAFNet (Chen, Chu, Zhang and Sun, "Simple Baselines for Image
Restoration", ECCV 2022; megvii-research/NAFNet
``basicsr/models/archs/NAFNet_arch.py``), NCHW in fp32, and the DN step's
image chain around it: MoePhoto's RGB tiler and the 8-bit output.

The network (state-dict keys as MoePhoto's ``python/NAFNet.py`` keeps
them: ``layers.{i}`` holds level i's encoder blocks, ``down``, ``up`` and
decoder blocks, ``layers.{L}`` the middle blocks):

    f = intro(x)                                        3x3, 3 -> width
    level i (c = width 2^i), i = 0 .. L-1:
        f = encoder_i(f); skip_i = f; f = down_i(f)     2x2 stride 2, c -> 2c
    f = middle(f)                                       at width 2^L
    level i, i = L-1 .. 0:
        f = decoder_i(PixelShuffle2(up_i(f)) + skip_i)  1x1, 2c -> 4c, no bias
    y = ending(f) + x                                   3x3, width -> 3

    NAFBlock(x), at c channels:
        t = SimpleGate(conv2(conv1(LayerNorm2d_1(x))))  1x1 c -> 2c, depthwise 3x3
        t = conv3(t * sca(t))                           sca = 1x1 conv of the mean over H, W
        z = x + beta t
        return z + gamma conv5(SimpleGate(conv4(LayerNorm2d_2(z))))
    SimpleGate(t) = t[:, :C/2] * t[:, C/2:]
    LayerNorm2d: over the channels of each pixel, biased variance, eps 1e-5

Departures from ``NAFNet_arch.py``, each pinned by a test
(``tests/test_torch_nafnet_reference.py``):

- LayerNorm2d's eps is 1e-5, MoePhoto's channels-last LayerNorm's; the
  published ``LayerNorm2d`` defaults to 1e-6.
- SCA pools over each tile, not over the image: MoePhoto runs the model
  on halo tiles of 256 (the registry's ``TileSpec(256, 16, 16, 1, 4)``),
  so the tiling is part of the function computed (``dnImage``).
- The image is reflect-padded at the bottom and right to the tiler's
  extent (a multiple of 16 at least); the published ``check_image_size``
  pads with zeros to a multiple of 16.

Every convolution is a ``layers.QConv2d`` (the depthwise and 1x1 ones
too), so that the benchmark's weight draw reaches them and the
correctness check's control quantises them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from benchmark.reference import lite
from benchmark.reference.layers import QConv2d

EPS = 1e-5


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = (x - mu).square().mean(1, keepdim=True)
        return (x - mu) / (var + self.eps).sqrt() * self.weight[:, None, None] + self.bias[:, None, None]


def simpleGate(x):
    a, b = x.chunk(2, dim=1)
    return a * b


class SCA(nn.Sequential):
    """Simplified channel attention's weights: the mean over H and W of
    each channel (of the tile it is given), then a 1x1 conv."""

    def __init__(self, c: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), QConv2d(c, c, 1))


class NAFBlock(nn.Module):
    def __init__(self, c: int, dwExpand: int = 2, ffnExpand: int = 2):
        super().__init__()
        dw, ffn = c * dwExpand, c * ffnExpand
        self.conv1 = QConv2d(c, dw, 1)
        self.conv2 = QConv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = QConv2d(dw // 2, c, 1)
        self.sca = SCA(dw // 2)
        self.conv4 = QConv2d(c, ffn, 1)
        self.conv5 = QConv2d(ffn // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x):
        t = simpleGate(self.conv2(self.conv1(self.norm1(x))))
        z = x + self.conv3(t * self.sca(t)) * self.beta
        return z + self.conv5(simpleGate(self.conv4(self.norm2(z)))) * self.gamma


class Level(nn.Module):
    """One level of the U-Net at width c."""

    def __init__(self, c: int, nEnc: int, nDec: int):
        super().__init__()
        self.encoder = nn.Sequential(*[NAFBlock(c) for _ in range(nEnc)])
        self.down = QConv2d(c, 2 * c, 2, stride=2)
        self.up = nn.Sequential(QConv2d(2 * c, 4 * c, 1, bias=False), nn.PixelShuffle(2))
        self.decoder = nn.Sequential(*[NAFBlock(c) for _ in range(nDec)])


class NAFNet(nn.Module):
    """(N, 3, H, W) -> (N, 3, H, W), H and W multiples of 2^L.
    ``decBlkNums`` lists the decoders' block counts from the deepest level
    out, as the published ``dec_blk_nums``."""

    def __init__(self, width: int = 32, middleBlkNum: int = 12, encBlkNums: Sequence[int] = (2, 2, 4, 8),
                 decBlkNums: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        L = len(encBlkNums)
        self.intro = QConv2d(3, width, 3, padding=1)
        self.ending = QConv2d(width, 3, 3, padding=1)
        levels = [Level(width << i, encBlkNums[i], decBlkNums[L - 1 - i]) for i in range(L)]
        self.layers = nn.ModuleList(levels + [nn.Sequential(*[NAFBlock(width << L) for _ in range(middleBlkNum)])])

    def forward(self, x):
        f, skips = self.intro(x), []
        for level in self.layers[:-1]:
            f = level.encoder(f)
            skips.append(f)
            f = level.down(f)
        f = self.layers[-1](f)
        for level, skip in zip(reversed(self.layers[:-1]), reversed(skips)):
            f = level.decoder(level.up(f) + skip)
        return self.ending(f) + x


def fromConfig(cfg: dict) -> NAFNet:
    """The configuration file's NAFNet (``benchmark/configs/nafnet_*.json``)."""
    return NAFNet(int(cfg["width"]), int(cfg["middle_blk_num"]), cfg["enc_blk_nums"], cfg["dec_blk_nums"])


# --- the weights -------------------------------------------------------------


class _Convs:
    """The model's convolutions alone, as ``harness/weights.drawWeights``
    walks a model (it knows no rule for a norm's weight or a block's
    scales)."""

    def __init__(self, model: nn.Module):
        self.model = model

    def named_modules(self):
        return [(n, m) for n, m in self.model.named_modules() if isinstance(m, nn.Conv2d)]


def drawWeights(model: NAFNet, rule: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """State dict for ``model`` from ``seed``: the convolutions by the
    harness's draw (``rule``'s ``gain``, ``bias_std`` and ``leaf_init``),
    then each LayerNorm2d's weight and bias and each block's ``beta`` and
    ``gamma`` by normal draws from a generator of their own (seeded by
    ``seed + 1``), around ``rule["norm"]`` and ``rule["scales"]`` ([mean,
    std] each)."""
    from benchmark.harness import weights

    sd = weights.drawWeights(_Convs(model), rule, seed, device, dtype)
    norm, scales = rule["norm"], rule["scales"]
    leaves = []
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("beta", "gamma"):
            leaves.append((name, p.shape, *scales[leaf]))
        elif name not in sd:
            leaves.append((name, p.shape, *norm[leaf]))
    g = torch.Generator(device=device).manual_seed((int(seed) + 1) % (1 << 64))
    for name, shape, mean, std in leaves:
        sd[name] = (torch.randn(shape, generator=g, device=device) * float(std) + float(mean)).to(dtype)
    return sd


# --- the DN step's chain -----------------------------------------------------


def tiledRGB(img: torch.Tensor, model: nn.Module, tile: int, pad: int, align: int, tilesPerCall: int = 4):
    """(3, H, W) fp32 -> (3, H, W): the image reflect-padded to the tiler's
    extent, RGB tiles of ``tile`` on a stride of ``tile - 2 pad`` through
    ``model`` (each tile alone: SCA pools over it), ``tilesPerCall`` a
    call, blended by the tiler's sigmoid windows on an fp32 canvas."""
    c, h, w = img.shape
    ph, pw = lite.paddedExtent(h, tile, pad, align), lite.paddedExtent(w, tile, pad, align)
    xp = lite.reflectPad(img, ph - h, pw - w)
    ys, xs = lite.planAxis(h, tile, pad), lite.planAxis(w, tile, pad)
    th, tw = min(tile, ph), min(tile, pw)
    canvas = torch.zeros((c, ph, pw), dtype=torch.float32, device=img.device)
    weight = torch.zeros((1, ph, pw), dtype=torch.float32, device=img.device)
    places = [(y, x, iy == 0, iy == len(ys) - 1, ix == 0, ix == len(xs) - 1)
              for iy, y in enumerate(ys) for ix, x in enumerate(xs)]
    for s in range(0, len(places), tilesPerCall):
        chunk = places[s : s + tilesPerCall]
        outs = model(torch.stack([xp[:, y : y + th, x : x + tw] for y, x, *_ in chunk]))
        for (y, x, fy, ly, fx, lx), out in zip(chunk, outs):
            win = (lite.axisWindow(th, pad, fy, ly)[:, None] * lite.axisWindow(tw, pad, fx, lx)[None, :]).to(img.device)
            canvas[:, y : y + th, x : x + tw] += out.float() * win
            weight[:, y : y + th, x : x + tw] += win
    return (canvas / weight.clamp_min(1e-8))[:, :h, :w]


@torch.no_grad()
def dnImage(model: NAFNet, image, spec: dict, device) -> torch.Tensor:
    """The DN step's result for a uint8 (H, W, 3) array, as the program
    computes it: the 8-bit (H, W, 3) output of the tiled model in fp32."""
    x = torch.as_tensor(image).to(device).permute(2, 0, 1).float() / 255.0
    y = tiledRGB(x, model, spec["tile"], spec["pad"], spec["align"], spec["batch"])
    return lite.toOutput8(y).permute(1, 2, 0)
