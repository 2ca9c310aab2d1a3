"""MPRNet multi-stage progressive restoration (reference
``python/MPRNet.py``; JAX ``models/mprnet.py``) as an ``nn.Module`` with
the checkpoint's keys.

Stage 1 encodes the four quadrants of the image and stage 2 its two
halves, each pair's features joined along W (stage 2) or H (stage 3)
before decoding; a SAM passes each stage's image on, and stage 3 (ORSNet)
runs at the original resolution.  The quadrants (and the halves) share
weights, so they run as one batch: four times (twice) the batch, a quarter
(half) of the calls.  Input H, W must be multiples of 8.

Widths (Zamir et al., CVPR 2021): n features, the U-Net levels n, n + s,
n + 2s, ORSNet at n + o; every conv without bias; a CAB is two 3x3 convs
around one PReLU and a channel attention of reduction 4.

The forward pass has three stages (``MPRNet.stages``), one a stage of the
published model: the quadrants' encoder and the halves' decoder and SAM;
the halves' encoder with the cross-stage fusion, their decoder joined
along H and the second SAM; ORSNet, ``tail`` and the residual.  Each model
call (a chunk of tiles) records one profiler span a stage while one
records (``progress.span``): ``moe.mprnet.stage1``, ``moe.mprnet.stage2``
and ``moe.mprnet.stage3``.  ``engine/executor.ModelExec`` replays the
stages as CUDA graphs for a full chunk on the card.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch import nn

from moephoto_tpu_torch.models.api import interpolateScale, onNHWC, prelu, runStages
from moephoto_tpu_torch.models.blocks import FRM

CA_REDUCTION = 4


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class CAB(nn.Sequential):
    """Channel attention block (JAX ``_cab``): conv 3x3 -> PReLU -> conv 3x3
    -> channel attention, plus the input; keys ``0``-``3``.  Runs on NCHW."""

    def __init__(self, c: int):
        super().__init__(_conv(c, c, 3), nn.PReLU(), _conv(c, c, 3), FRM(c, c // CA_REDUCTION, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self[3](self[2](prelu(self[0](x), self[1].weight)))


class Resample(nn.Sequential):
    """UpSample / DownSample: bilinear resize by ``scale`` (no antialias),
    then a 1x1 conv (key ``1``; the resize is module ``0``)."""

    def __init__(self, cin: int, cout: int, scale: float):
        super().__init__(nn.Identity(), _conv(cin, cout, 1))
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](onNHWC(interpolateScale, x, self.scale))


class SAM(nn.Module):
    """Supervised attention module, 1x1 convs: (features, image) ->
    (features gated by the stage's image, the stage's image)."""

    def __init__(self, n: int):
        super().__init__()
        self.conv1 = _conv(n, n, 1)
        self.conv2 = _conv(n, 3, 1)
        self.conv3 = _conv(3, n, 1)

    def forward(self, x: torch.Tensor, xImg: torch.Tensor):
        img = self.conv2(x) + xImg
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


def _widths(n: int, s: int) -> List[int]:
    return [n, n + s, n + 2 * s]


class Encoder(nn.Module):
    """Three levels, each (downsample from the level above, CAB, CAB); with
    ``csff`` the stage adds 1x1 convs of the previous stage's encoder and
    decoder features at each level."""

    def __init__(self, n: int, s: int, csff: bool):
        super().__init__()
        w = _widths(n, s)
        self.encoder = nn.ModuleList([
            nn.Sequential(nn.Identity() if i == 0 else Resample(w[i - 1], c, 0.5), CAB(c), CAB(c))
            for i, c in enumerate(w)])
        if csff:
            self.csff_enc = nn.ModuleList([_conv(c, c, 1) for c in w])
            self.csff_dec = nn.ModuleList([_conv(c, c, 1) for c in w])

    def forward(self, x: torch.Tensor, encOuts: Optional[List[torch.Tensor]] = None,
                decOuts: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        outs = []
        for i, level in enumerate(self.encoder):
            x = level(x)
            if encOuts is not None:
                x = x + self.csff_enc[i](encOuts[i]) + self.csff_dec[i](decOuts[i])
            outs.append(x)
        return outs


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = Resample(cin, cout, 2.0)


class Decoder(nn.Module):
    """From the deepest level out: two CABs a level, the level above
    upsampled (``up.{i}``) and added to a CAB of the encoder's skip
    (``skip_attn.{i}``)."""

    def __init__(self, n: int, s: int):
        super().__init__()
        w = _widths(n, s)
        self.decoder = nn.ModuleList([nn.Sequential(CAB(c), CAB(c)) for c in w])
        self.skip_attn = nn.ModuleList([CAB(c) for c in w[:2]])
        self.up = nn.ModuleList([_Up(w[i + 1], w[i]) for i in range(2)])

    def forward(self, outs: List[torch.Tensor]) -> List[torch.Tensor]:
        x = self.decoder[2](outs[2])
        dec = [None, None, x]
        for i in (1, 0):
            x = self.decoder[i](self.up[i].up(x) + self.skip_attn[i](outs[i]))
            dec[i] = x
        return dec


class ORSNet(nn.Module):
    """The original-resolution stage at n + o: three ORBs (``numCab`` CABs
    and a 3x3 conv, plus the input), each followed by the previous stage's
    encoder and decoder features of level i, upsampled i times to width n
    (``conv_enc/dec.{i}.{j}``) and taken to n + o by a 1x1 conv."""

    def __init__(self, n: int, s: int, o: int, numCab: int):
        super().__init__()
        w = n + o
        self.orb = nn.ModuleList([nn.Sequential(*[CAB(w) for _ in range(numCab)], _conv(w, w, 3))
                                  for _ in range(3)])

        def encDec(i):
            ups = [Resample(n + (i - j) * s, n + (i - j - 1) * s, 2.0) for j in range(i)]
            return nn.Sequential(*ups, _conv(n, w, 1))

        self.conv_enc = nn.ModuleList([encDec(i) for i in range(3)])
        self.conv_dec = nn.ModuleList([encDec(i) for i in range(3)])

    def forward(self, x: torch.Tensor, encOuts: List[torch.Tensor], decOuts: List[torch.Tensor]) -> torch.Tensor:
        for i in range(3):
            x = x + self.orb[i](x)
            x = x + self.conv_enc[i](encOuts[i]) + self.conv_dec[i](decOuts[i])
        return x


def _pairUp(f: torch.Tensor, b: int, dim: int) -> torch.Tensor:
    """Features of 2k b patches batched as [pair][member][b] -> k b patches,
    each pair's two members joined along NCHW dim ``dim``."""
    f = f.unflatten(0, (-1, 2, b))
    return torch.cat([f[:, 0], f[:, 1]], dim + 1).flatten(0, 1)


class MPRNet(nn.Module):
    """(B, H, W, 3) -> (B, H, W, 3) clipped to [0, 1]."""

    def __init__(self, nFeat: int = 96, scaleUnetFeats: int = 48, scaleOrsnetFeats: int = 32, numCab: int = 8):
        super().__init__()
        n, s, o = nFeat, scaleUnetFeats, scaleOrsnetFeats
        self.shallow_feat = nn.ModuleList([nn.Sequential(_conv(3, n, 3), CAB(n)) for _ in range(3)])
        self.encoder = nn.ModuleList([Encoder(n, s, False), Encoder(n, s, True), ORSNet(n, s, o, numCab)])
        self.decoder = nn.ModuleList([Decoder(n, s), Decoder(n, s)])
        self.sam = nn.ModuleList([SAM(n), SAM(n)])
        self.concat = nn.ModuleList([_conv(2 * n, n, 3), _conv(2 * n, n + o, 3)])
        self.tail = _conv(n + o, 3, 3)

    def stages(self):
        """The forward pass as (span name, function) pairs, each function
        taking the result of the one before: the (B, H, W, 3) input, then
        (the NCHW input, its halves, stage 1's joined encoder and decoder
        features, the SAM's features), then (the NCHW input, stage 2's
        encoder and decoder features, the SAM's features), then the output."""
        return (("moe.mprnet.stage1", self._stage1), ("moe.mprnet.stage2", self._stage2),
                ("moe.mprnet.stage3", self._stage3))

    def _stage1(self, inp: torch.Tensor):
        x3 = inp.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        b, _, h, w = x3.shape
        if h % 8 or w % 8:
            raise ValueError(f"MPRNet needs H, W % 8 == 0, got {h}x{w}")
        top, bot = x3[:, :, : h // 2], x3[:, :, h // 2:]
        quads = torch.cat([top[..., : w // 2], top[..., w // 2:], bot[..., : w // 2], bot[..., w // 2:]])
        halves = torch.cat([top, bot])
        enc = [_pairUp(f, b, 3) for f in self.encoder[0](self.shallow_feat[0](quads))]
        dec = self.decoder[0](enc)
        xSam, _ = self.sam[0](dec[0], halves)
        return x3, halves, enc, dec, xSam

    def _stage2(self, state):
        x3, halves, enc, dec, xSam = state
        xCat = self.concat[0](torch.cat([self.shallow_feat[1](halves), xSam], 1))
        enc = [_pairUp(f, x3.shape[0], 2) for f in self.encoder[1](xCat, enc, dec)]
        dec = self.decoder[1](enc)
        xSam, _ = self.sam[1](dec[0], x3)
        return x3, enc, dec, xSam

    def _stage3(self, state) -> torch.Tensor:
        x3, enc, dec, xSam = state
        xCat = self.concat[1](torch.cat([self.shallow_feat[2](x3), xSam], 1))
        return (self.tail(self.encoder[2](xCat, enc, dec)) + x3).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return runStages(self.stages(), x)


# registry configurations (JAX mprnet.py:154-156)
mprNet = MPRNet  # deblurring
mprNetDenoise = functools.partial(MPRNet, 80, 48, 32)
mprNetDerain = functools.partial(MPRNet, 40, 20, 16)
