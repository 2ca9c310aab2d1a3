"""Plain IFRNet-M frame interpolation (Kong et al., CVPR 2022,
github.com/ltkong218/IFRNet ``models/IFRNet_M.py``, as opteroncx/MoePhoto
``python/IFRNet.py`` runs it), NCHW, and the slomo x2 video chain around
it.

Per pair of frames (MoePhoto's form): each frame less its own mean goes
through a 4-level pyramid encoder (stride-2 conv + conv, PReLU, widths
32/48/72/96); a coarse-to-fine decoder of four levels (conv, a residual
block whose last 32 channels take two extra convs, ConvTranspose 4/2/1)
warps both frames' features by the flows of the level below and refines
the flows; the last level gives both flows at full size, a mask and a
residual.  The result is mask * warp(frame0) + (1 - mask) * warp(frame1)
+ the time-interpolated mean + the residual, clipped to [0, 1].  Warps
sample bilinearly with border padding (the published ``warp``).

The chain: 16-bit BGR frames -> RGB in [0, 1) (value / 65536), padded by
reflection to multiples of 16 rows and columns, interpolated at t = 0.5,
cropped, back to BGR and quantised to 16 bits (times 65536, clipped,
truncated).  The frame means are taken over the padded frame, as the
chain runs the model on it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import QConv2d, QConvTranspose2d

WIDTHS, SIDE = (32, 48, 72, 96), 32
ALIGN = 16


def convPrelu(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(QConv2d(cin, cout, k, stride, k // 2), nn.PReLU(cout))


class ResBlock(nn.Module):
    def __init__(self, c: int, side: int):
        super().__init__()
        self.side = side
        self.conv1, self.conv3 = convPrelu(c, c), convPrelu(c, c)
        self.conv2, self.conv4 = convPrelu(side, side), convPrelu(side, side)
        self.conv5 = QConv2d(c, c, 3, 1, 1)
        self.prelu = nn.PReLU(c)

    def forward(self, x):
        s = self.side
        out = self.conv1(x)
        out = self.conv3(torch.cat([out[:, :-s], self.conv2(out[:, -s:])], 1))
        out = self.conv5(torch.cat([out[:, :-s], self.conv4(out[:, -s:])], 1))
        return self.prelu(x + out)


def decoderChannels():
    """(in, mid, out) of the four decoder levels, coarse to fine."""
    c = WIDTHS
    levels = [(2 * c[3] + 1, 2 * c[3], 4 + c[2])]
    for i in range(1, 4):
        levels.append((3 * c[3 - i] + 4, 3 * c[3 - i], 4 + c[2 - i] if i < 3 else 8))
    return levels


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        chans = (3,) + WIDTHS
        self.pyramids = nn.ModuleList(
            nn.Sequential(convPrelu(chans[i], chans[i + 1], 3, 2), convPrelu(chans[i + 1], chans[i + 1]))
            for i in range(4))

    def forward(self, x):
        feats = []
        for level in self.pyramids:
            x = level(x)
            feats.append(x)
        return feats  # 1/2, 1/4, 1/8, 1/16


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.decoders = nn.ModuleList(
            nn.Sequential(convPrelu(cin, mid), ResBlock(mid, SIDE), QConvTranspose2d(mid, cout, 4, 2, 1))
            for cin, mid, cout in decoderChannels())


def warp(img, flow):
    """The published backward warp: bilinear, border padding, corners
    aligned, so a pixel samples at exactly (x + u, y + v)."""
    b, _, h, w = flow.shape
    xx = torch.linspace(-1.0, 1.0, w, device=flow.device).view(1, 1, 1, w).expand(b, -1, h, -1)
    yy = torch.linspace(-1.0, 1.0, h, device=flow.device).view(1, 1, h, 1).expand(b, -1, -1, w)
    grid = torch.cat([xx, yy], 1)
    f = torch.cat([flow[:, 0:1] / ((w - 1.0) / 2.0), flow[:, 1:2] / ((h - 1.0) / 2.0)], 1)
    return F.grid_sample(img, (grid + f).permute(0, 2, 3, 1), mode="bilinear", padding_mode="border",
                         align_corners=True)


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


class IFRNetM(nn.Module):
    """``encoder.pyramids.*`` and ``decoder.decoders.*`` as the checkpoint's
    two state dicts, prefixed."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()

    def normalise(self, frames):
        """(N, 3, H, W) -> per-frame means (N, 1, 1, 1) and frames less them."""
        m = frames.double().mean(dim=(1, 2, 3), keepdim=True).float()
        return m, frames - m

    def interpolate(self, f0, f1, n0, n1, m0, m1, t: float):
        """Features of both frames (each 1/2 .. 1/16), the normalised frames
        and their means -> the frame at time ``t`` (N, 3, H, W) in [0, 1]."""
        d = self.decoder.decoders
        emb = torch.full_like(f0[3][:, :1], t)
        out = d[0](torch.cat([f0[3], f1[3], emb], 1))
        flow0, flow1, ft = out[:, 0:2], out[:, 2:4], out[:, 4:]
        for i in (1, 2, 3):
            lvl = 3 - i
            x = torch.cat([ft, warp(f0[lvl], flow0), warp(f1[lvl], flow1), flow0, flow1], 1)
            out = d[i](x)
            flow0 = out[:, 0:2] + 2.0 * up2(flow0)
            flow1 = out[:, 2:4] + 2.0 * up2(flow1)
            ft = out[:, 4:]
        mask, res = torch.sigmoid(ft[:, 0:1]), ft[:, 1:]
        mean = (1 - t) * m0 + t * m1
        merged = mask * warp(n0, flow0) + (1 - mask) * warp(n1, flow1) + mean
        return (merged + res).clamp(0.0, 1.0)

    def forward(self, frame0, frame1, t: float = 0.5):
        m, n = self.normalise(torch.cat([frame0, frame1]))
        f = self.encoder(n)
        f0, f1 = [x[:1] for x in f], [x[1:] for x in f]
        return self.interpolate(f0, f1, n[:1], n[1:], m[:1], m[1:], t)


def stateDict(ckpt: dict) -> dict:
    """The checkpoint's ``{"encoder": sd, "decoder": sd}`` as one dict."""
    return {f"{mod}.{k}": v for mod in ("encoder", "decoder") for k, v in ckpt[mod].items()}


def checkpoint(sd: dict) -> dict:
    """One state dict -> the checkpoint's two."""
    return {mod: {k[len(mod) + 1 :]: v for k, v in sd.items() if k.startswith(mod + ".")}
            for mod in ("encoder", "decoder")}


def frameFromBytes(raw: bytes, h: int, w: int, device) -> torch.Tensor:
    """16-bit BGR bytes -> (1, 3, H, W) RGB fp32 in [0, 1)."""
    v = np.frombuffer(raw, dtype=np.uint16, count=h * w * 3).reshape(h, w, 3)
    x = torch.from_numpy(v.astype(np.float32)).to(device) / 65536.0
    return x.flip(-1).permute(2, 0, 1)[None]


def alignPad(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    ph, pw = -h % ALIGN, -w % ALIGN
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


def toBytes16(y: torch.Tensor) -> np.ndarray:
    """(1, 3, H, W) RGB in [0, 1] -> (H, W, 3) BGR uint16, as the chain's
    output step quantises: times 65536, clipped to [0, 65535], truncated."""
    q = (y[0].permute(1, 2, 0).flip(-1).float() * 65536).clamp(0, 65535).to(torch.int32)
    return q.cpu().numpy().astype(np.uint16)


@torch.no_grad()
def interpolateFrames(model: IFRNetM, raw0: bytes, raw1: bytes, h: int, w: int, device) -> np.ndarray:
    """The chain's frame between two input frames: (H, W, 3) BGR uint16."""
    a = alignPad(frameFromBytes(raw0, h, w, device))
    b = alignPad(frameFromBytes(raw1, h, w, device))
    return toBytes16(model(a, b, 0.5)[:, :, :h, :w])
