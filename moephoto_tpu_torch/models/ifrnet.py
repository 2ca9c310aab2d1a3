"""IFRNet flow-based frame interpolation at any real factor sf >= 1
(reference ``python/IFRNet.py``; Kong et al., CVPR 2022).

Per frame pair: a 4-level pyramid encoder, a coarse-to-fine decoder that
warps the features of both frames by the flows of the level below, and
a merge (mask-blended warps of both frames, plus the time-interpolated
mean and a residual).  Every warp goes through :func:`ops.warp.warp`
(K2, a CUDA kernel on the card).  The time embedding (:class:`EmbtState`)
and the cosine-similarity frame deduper (:class:`Deduper`) run on the
host; :func:`doSlomo` assembles them into a stream graph.

Tensors are NHWC at every function boundary, as in the JAX package
(``moephoto_tpu/models/ifrnet.py``); convolutions run on NCHW views of
them (channels-last in memory on the card).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.stream import InfiniteSource, RowRef, Stream, StreamGraph, stackBatch
from moephoto_tpu_torch.models.api import prelu, resizeBilinear
from moephoto_tpu_torch.models.streamcommon import StreamOpt, alignPad, makeStreamFunc
from moephoto_tpu_torch.ops.warp import rowReach, warp, warpSpmd
from moephoto_tpu_torch.parallel import sharded
from moephoto_tpu_torch.parallel.mesh import replicaOn
from moephoto_tpu_torch.parallel.sharded import RowShards, rowSegment, scaleBounds, zipShards
from moephoto_tpu_torch.parallel.temporal import rowStage
from moephoto_tpu_torch.progress import Node

Channels = dict(
    S=[24, 36, 54, 72],
    M=[32, 48, 72, 96],
    L=[(64, 7), 96, 144, 192],
)
SideChannels = dict(S=24, M=32, L=64)
RefTime = 2

modelPaths = dict(
    S="model/IFRNet/IFRNet_S_GoPro.pth",
    M="model/IFRNet/IFRNet_GoPro.pth",
    L="model/IFRNet/IFRNet_L_GoPro.pth",
)

# each decoder level's ConvTranspose is its child 2
isConvT = lambda k, s: k.startswith("decoder.decoders.") and k.endswith(".2.weight")


def widths(size: str) -> List[Tuple[int, int]]:
    """(channels, first kernel) of each encoder level."""
    return [c if isinstance(c, tuple) else (c, 3) for c in Channels[size]]


def decoderChannels(size: str) -> List[Tuple[int, int, int]]:
    """(in, mid, out) channels of each decoder level, coarse to fine.
    Level 0 takes both frames' coarsest features and the time; level
    i > 0 the residual features, both warped feature maps and both flows;
    each outputs 4 flow channels plus the features of the next level
    (8 at the last: mask 1 + residual 3)."""
    c = [w for w, _ in widths(size)]
    out = [(2 * c[3] + 1, 2 * c[3], 4 + c[2])]
    for i in range(1, 4):
        out.append((3 * c[3 - i] + 4, 3 * c[3 - i], 4 + c[2 - i] if i < 3 else 8))
    return out


def warpExact(img, flow, reach: Optional[int] = None):
    """IFRNet's Warp (IFRNet.py:19-35): its kw/kh normalisation and
    align_corners=True cancel, so it samples at exactly x + u, border
    padding.  Row shards take K2a (:func:`ops.warp.warpSpmd`), as the JAX
    package's row-sharded stages take ``warpBoundedSpmd``; ``reach`` is the
    flows' row reach when the caller read it once for a pair of warps."""
    if isinstance(img, RowShards):
        return warpSpmd(img, flow, "border", reach)
    return warp(img, flow, "border")


# Row-sharded stages (``moephoto_tpu/models/ifrnet.py:510-575`` under a mesh):
# frames are padded to ALIGN rows (``doSlomo``), so row shards of multiples of
# ALIGN rows split every pyramid level at whole rows.  Each segment's halo is
# its row reach in input rows:
#   an encoder level (conv k/2 -> conv 3/1): k // 2 rows for the first conv
#   and one row of its output, two input rows, for the second, rounded up to
#   an even count so the crop is whole output rows;
#   a decoder level (ConvRelu -> ResBlock of five 3x3 convs -> ConvTranspose
#   4/2/1): six convs of one row each and one row for the transposed conv;
#   the 2x bilinear resize of the up-flows: one row.
# A segment whose input lies at pyramid level GATHER_FROM_LEVEL or coarser
# (1/8 and 1/16 of the frame's rows) runs gathered, at any resolution: the
# flows are estimated there and upsampled 8 and 16 times, so a one-ulp change
# there moves the whole frame, and such a map is small work to shard.  cuDNN
# picks its algorithm by shape, and in bf16 that can round a value one ulp
# apart: at 1080p on 2 shards the 1/16 level's transposed conv did so for
# 0.008 % of its values on a 41-row slab.  Sharding the 1/8-level segments
# left interpolated frames up to 0.018 apart at 1080p and 0.015 at 2160p on 4
# shards; gathering them gave 0 LSB at 1080p and 2160p on 2 and 4 shards
# (PERF.md).
ALIGN = 16
DEC_HALO = 7
RESIZE_HALO = 1
GATHER_FROM_LEVEL = 3  # pyramid level i holds the frame's rows / 2^i


def encoderHalo(k: int) -> int:
    return -(-(k // 2 + 2) // 2) * 2


class ConvRelu(nn.Sequential):
    """conv (k, stride, k // 2 padding) -> per-channel PReLU, on NCHW."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, k, stride, k >> 1), nn.PReLU(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(self[0](x), self[1].weight)


class Encoder(nn.Module):
    """Pyramid encoder (IFRNet.py:44-60): (B, H, W, 3) -> features at 1/16,
    1/8, 1/4 and 1/2 resolution, smallest first, each NHWC."""

    def __init__(self, size: str):
        super().__init__()
        self.pyramids = nn.ModuleList()
        cin = 3
        for c, k in widths(size):
            self.pyramids.append(nn.Sequential(ConvRelu(cin, c, k, 2), ConvRelu(c, c)))
            cin = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cur = x.permute(0, 3, 1, 2)
        feats = []
        for level in self.pyramids:
            cur = level(cur)
            feats.append(cur.permute(0, 2, 3, 1))
        return feats[::-1]


class ResBlock(nn.Module):
    """Residual block whose last ``side`` channels take extra convs
    (IFRNet.py:62-79)."""

    def __init__(self, c: int, side: int):
        super().__init__()
        self.side = side
        self.conv1, self.conv3 = ConvRelu(c, c), ConvRelu(c, c)
        self.conv2, self.conv4 = ConvRelu(side, side), ConvRelu(side, side)
        self.conv5 = nn.Conv2d(c, c, 3, 1, 1)
        self.prelu = nn.PReLU(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.side
        out = self.conv1(x)
        out = torch.cat([out[:, :-s], self.conv2(out[:, -s:])], 1)
        out = self.conv3(out)
        out = torch.cat([out[:, :-s], self.conv4(out[:, -s:])], 1)
        return prelu(x + self.conv5(out), self.prelu.weight)


class DecoderLevel(nn.Sequential):
    """conv -> ResBlock -> ConvTranspose 4/2/1 (2x up), NHWC in and out."""

    def __init__(self, cin: int, mid: int, cout: int, side: int):
        super().__init__(ConvRelu(cin, mid), ResBlock(mid, side), nn.ConvTranspose2d(mid, cout, 4, 2, 1))

    def forward(self, x: torch.Tensor, flowOnly: bool = False) -> torch.Tensor:
        """``flowOnly``: the ConvTranspose cut to the 4 flow channels (the
        reference's FlowDecoder, IFRNet.py:87-92: same weights, output rows
        :4)."""
        y = self[1](self[0](x.permute(0, 3, 1, 2)))
        up = self[2]
        if flowOnly:
            y = F.conv_transpose2d(y, up.weight[:, :4], up.bias[:4], stride=2, padding=1)
        else:
            y = up(y)
        return y.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    def __init__(self, size: str):
        super().__init__()
        side = SideChannels[size]
        self.decoders = nn.ModuleList([DecoderLevel(*ch, side) for ch in decoderChannels(size)])


# Spatial TTA transforms on (n, H, W, c), the reference's trans/transInv
# tables (imageProcess.py:564-570): the inverse table swaps 3 and 4, the
# rest are their own inverses.
_T = lambda x: x.transpose(1, 2)
_F = lambda x: x.flip(2)
_TRANS = [
    _T,
    _F,
    lambda x: x.flip(1, 2),
    lambda x: _T(_F(x)),
    lambda x: _F(_T(x)),
    lambda x: _T(_F(_T(x))),
    lambda x: _T(x.flip(1, 2)),
]
_TRANS_INV = [_TRANS[j] for j in (0, 1, 2, 4, 3, 5, 6)]


def _repeatK(x: torch.Tensor, k: int) -> torch.Tensor:
    """(r, ...) -> (r * k, ...), each row k times; a view when r or k is 1
    (a stride-0 batch, which the warp kernel reads in place)."""
    r, rest = x.shape[0], x.shape[1:]
    return x[:, None].expand(r, k, *rest).reshape(r * k, *rest)


class IFRNet(nn.Module):
    """IFRNet-S/M/L: keys ``encoder.pyramids.*`` and ``decoder.decoders.*``
    as the reference checkpoint's two state dicts, prefixed."""

    def __init__(self, size: str = "M"):
        super().__init__()
        self.size = size
        self.encoder = Encoder(size)
        self.decoder = Decoder(size)

    # Each frame's mean is summed in fp64 and rounded once to fp32: a
    # decoded frame's values are multiples of 2^-16, whose fp64 sums are
    # exact in any order, so the sharded stage's per-shard sums give the
    # single-device mean bit for bit (an fp32 sum would not, and in bf16 a
    # mean one ulp apart moves roundings through the whole network).
    def _encodeFullPlain(self, frames: torch.Tensor):
        dtype = self.encoder.pyramids[0][0][0].weight.dtype
        n = frames[0].numel()
        m = (frames.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.float64) / n).float()
        inpN = frames - m.to(frames.dtype)
        return m, inpN, self.encoder(inpN.to(dtype))

    def _encodeFullSharded(self, frames: RowShards):
        """The encoder stage on row shards: the means summed per shard (in
        fp64, as above) and combined on the first device; each pyramid level
        a segment of :func:`encoderHalo` rows."""
        dtype = self.encoder.pyramids[0][0][0].weight.dtype
        home = frames.parts[0].device
        total = torch.stack([p.sum(dim=(1, 2, 3), dtype=torch.float64).to(home) for p in frames.parts]).sum(0)
        m = (total / (frames.rows * frames.shape[2] * frames.shape[3])).float().reshape(-1, 1, 1, 1)
        inpN = frames.map(lambda p: p - m.to(p.device, p.dtype))
        cur, feats = inpN.map(lambda p: p.to(dtype)), []
        for i, level in enumerate(self.encoder.pyramids):
            nchw = lambda t, level=level: replicaOn(level, t.device)(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            cur = rowSegment(nchw, cur, encoderHalo(level[0][0].kernel_size[0]), Fraction(1, 2), i >= GATHER_FROM_LEVEL)
            feats.append(cur)
        return m, inpN, feats[::-1]

    # frames (r, H, W, 3) fp32 -> (means (r, 1, 1, 1) fp32, normalised frames
    # fp32, the 4 feature levels in the model's dtype, smallest first).  Under a
    # mesh the rows shard (multiples of ALIGN) and the levels stay row shards.
    encodeFull = rowStage(_encodeFullPlain, _encodeFullSharded, (None, 1), (None, None, 1), align=ALIGN)

    def _flowEnsemble(self, level: DecoderLevel, xF: torch.Tensor, n: int):
        """Sum of inverse-transformed flow-only decodes over the first
        ``n`` TTA transforms (IFRNet.py:93, :146-149).  As in the
        reference, only the spatial layout is transformed back, never the
        flow channels."""

        def group(idxs):
            if not idxs:
                return 0
            ys = level(torch.cat([_TRANS[j](xF) for j in idxs]), flowOnly=True)
            return sum(_TRANS_INV[j](y) for j, y in zip(idxs, ys.chunk(len(idxs))))

        same = group([j for j in (1, 2, 5) if j < n])  # shape-preserving
        swapped = group([j for j in (0, 3, 4, 6) if j < n])  # transposed
        return same + swapped

    def decode(self, feats: List[torch.Tensor], embt: torch.Tensor, ensemble: int = 0) -> torch.Tensor:
        """Coarse-to-fine decoder (IFRNet.py:94-159) for r frame pairs.

        feats: 4 levels small to large, each (r, 2, h, w, c); embt (r, k)
        interpolation times -> (r * k, H, W, 8): flows 0 and 1, mask,
        residual.  ``ensemble`` (0..7): per-level flow TTA, the mean of the
        base flows and ``ensemble`` transformed flow-only decodes."""
        r, k = embt.shape
        f0 = feats[0]
        x0 = _repeatK(torch.cat([f0[:, 0], f0[:, 1]], -1), k)
        h0, w0 = x0.shape[1], x0.shape[2]
        embtMap = embt.reshape(r * k, 1, 1, 1).to(x0.dtype).expand(r * k, h0, w0, 1)
        args: Tuple = (x0, embtMap)
        for i, level in enumerate(self.decoder.decoders):
            if i:
                ft = feats[i]
                f0w = warpExact(_repeatK(ft[:, 0], k), upFlow0)
                f1w = warpExact(_repeatK(ft[:, 1], k), upFlow1)
                args = (ftRes, f0w, f1w, upFlow0, upFlow1)
            xF = torch.cat(args, -1)
            out = level(xF)
            if ensemble:
                flows = out[..., :4] + self._flowEnsemble(level, xF, ensemble)
                out = torch.cat([flows / (ensemble + 1), out[..., 4:]], -1)
            f0_, f1_, ftRes = out[..., :2], out[..., 2:4], out[..., 4:]
            if i:
                h, w = f0_.shape[1], f0_.shape[2]
                f0_ = f0_ + 2.0 * resizeBilinear(upFlow0, h, w)
                f1_ = f1_ + 2.0 * resizeBilinear(upFlow1, h, w)
            upFlow0, upFlow1 = f0_, f1_
        return torch.cat([upFlow0, upFlow1, ftRes], -1)

    @staticmethod
    def postOut(pairN: torch.Tensor, means: torch.Tensor, embt: torch.Tensor,
                decoded: torch.Tensor) -> torch.Tensor:
        """Final merge (IFRNet ``postOut`` :164-187) for r pairs.

        pairN (r, 2, H, W, 3) mean-normalised frames, means (r, 2, 1, 1, 1),
        embt (r, k) fp32, decoded (r * k, H, W, 8) -> (r * k, H, W, 3) fp32
        in [0, 1]: the warps blended by the sigmoid mask, plus the
        time-interpolated mean and the residual."""
        r, k = embt.shape
        upFlow0, upFlow1 = decoded[..., :2], decoded[..., 2:4]
        upMask = torch.sigmoid(decoded[..., 4:5])
        upRes = decoded[..., 5:]
        e = embt.float().reshape(r, k, 1, 1, 1)
        meanP = ((1 - e) * means[:, 0, None] + e * means[:, 1, None]).reshape(r * k, 1, 1, 1)
        img0w = warpExact(_repeatK(pairN[:, 0], k), upFlow0)
        img1w = warpExact(_repeatK(pairN[:, 1], k), upFlow1)
        merged = upMask * (img0w - img1w) + img1w + meanP.to(decoded.dtype)
        return (merged + upRes).float().clamp(0.0, 1.0)

    def _decodePostPlain(self, feats, embt, pairN, means, ensemble: int = 0) -> torch.Tensor:
        dtype = feats[0].dtype
        preds = []
        for i in range(embt.shape[0]):
            t = embt[i : i + 1]
            dec = self.decode([f[i : i + 1] for f in feats], t.to(dtype), ensemble)
            preds.append(self.postOut(pairN[i : i + 1], means[i : i + 1], t, dec))
        return torch.stack(preds)

    def _decodeSharded(self, feats: List[RowShards], embt: torch.Tensor, ensemble: int) -> RowShards:
        """:meth:`decode` on row shards (the levels (r, 2, h, w, c) on axis 2)
        -> (r * k, H, W, 8) on axis 1: each level a segment of DEC_HALO rows,
        the warps through K2a, the up-flows' resize a segment of RESIZE_HALO
        rows.  The flow ensemble's transposed decodes run gathered."""
        r, k = embt.shape
        f0 = feats[0]
        x0 = f0.map(lambda p: _repeatK(torch.cat([p[:, 0], p[:, 1]], -1), k), axis=1)
        embtMap = x0.map(lambda p: embt.to(p.device).reshape(r * k, 1, 1, 1).to(p.dtype)
                         .expand(r * k, p.shape[1], p.shape[2], 1))
        args: Tuple = (x0, embtMap)
        for i, level in enumerate(self.decoder.decoders):
            if i:
                ft = feats[i]
                reach = rowReach(upFlow0.parts + upFlow1.parts, 1)  # one host read for both warps
                f0w = warpExact(ft.map(lambda p: _repeatK(p[:, 0], k), axis=1), upFlow0, reach)
                f1w = warpExact(ft.map(lambda p: _repeatK(p[:, 1], k), axis=1), upFlow1, reach)
                args = (ftRes, f0w, f1w, upFlow0, upFlow1)
            xF = zipShards(lambda *ps: torch.cat(ps, -1), *args)
            coarse = 4 - i >= GATHER_FROM_LEVEL  # decoder level i's input (and its up-flows' resize's) is at 4 - i
            out = rowSegment(lambda t, level=level: replicaOn(level, t.device)(t), xF, DEC_HALO, 2, coarse)
            if ensemble:
                sharded.stats["gathers"] += 1
                whole = xF.gather()
                ens = RowShards.split(self._flowEnsemble(replicaOn(level, whole.device), whole, ensemble),
                                      out.devices, 1, bounds=out.bounds)
                out = zipShards(lambda o, e: torch.cat([(o[..., :4] + e) / (ensemble + 1), o[..., 4:]], -1),
                                out, ens)
            f0_, f1_ = out.map(lambda p: p[..., :2]), out.map(lambda p: p[..., 2:4])
            ftRes = out.map(lambda p: p[..., 4:])
            if i:
                up = lambda t: resizeBilinear(t, 2 * t.shape[1], 2 * t.shape[2])
                addUp = lambda f, u: zipShards(lambda a, b: a + 2.0 * b, f,
                                               rowSegment(up, u, RESIZE_HALO, 2, coarse))
                f0_, f1_ = addUp(f0_, upFlow0), addUp(f1_, upFlow1)
            upFlow0, upFlow1 = f0_, f1_
        return zipShards(lambda a, b, c: torch.cat([a, b, c], -1), upFlow0, upFlow1, ftRes)

    @staticmethod
    def _postOutSharded(pairN: RowShards, means: torch.Tensor, embt: torch.Tensor, decoded: RowShards) -> RowShards:
        """:meth:`postOut` on row shards (pairN on axis 2, decoded on axis 1)
        -> (r * k, H, W, 3) on axis 1, the warps through K2a."""
        r, k = embt.shape
        e = embt.float().reshape(r, k, 1, 1, 1)
        meanP = ((1 - e) * means[:, 0, None] + e * means[:, 1, None]).reshape(r * k, 1, 1, 1)
        reach = rowReach(decoded.parts, [1, 3])  # both flows' v, one host read for both warps
        img0w = warpExact(pairN.map(lambda p: _repeatK(p[:, 0], k), axis=1), decoded.map(lambda p: p[..., :2]), reach)
        img1w = warpExact(pairN.map(lambda p: _repeatK(p[:, 1], k), axis=1), decoded.map(lambda p: p[..., 2:4]),
                          reach)

        def merge(d, a, b):
            merged = torch.sigmoid(d[..., 4:5]) * (a - b) + b + meanP.to(d.device, d.dtype)
            return (merged + d[..., 5:]).float().clamp(0.0, 1.0)

        return zipShards(merge, decoded, img0w, img1w)

    def _decodePostSharded(self, feats, embt, pairN, means, ensemble: int = 0) -> RowShards:
        """The decode stage on row shards: ``pairN`` cut at multiples of
        ALIGN rows over the video mesh (or given so), the levels at those
        bounds scaled; pair after pair as :meth:`decodePost`."""
        from moephoto_tpu_torch.parallel.temporal import videoMesh

        if not isinstance(pairN, RowShards):
            pairN = RowShards.split(pairN, videoMesh().flat, 2, ALIGN)
        H = pairN.rows
        feats = [f if isinstance(f, RowShards) else
                 RowShards.split(f, pairN.devices, 2, bounds=scaleBounds(pairN.bounds, Fraction(f.shape[2], H)))
                 for f in feats]
        dtype = feats[0].parts[0].dtype
        preds = []
        for i in range(embt.shape[0]):
            t = embt[i : i + 1]
            one = lambda x: x.map(lambda p: p[i : i + 1])
            dec = self._decodeSharded([one(f) for f in feats], t.to(dtype), ensemble)
            preds.append(self._postOutSharded(one(pairN), means[i : i + 1], t, dec))
        return zipShards(lambda *ps: torch.stack(ps), *preds, axis=2)

    # Decoder and merge for r pairs with k times each -> (r, k, H, W, 3), one
    # pair after another, as the JAX package's chunk program unrolls them: each
    # warp runs at one pair's shapes.  (:meth:`decode` and :meth:`postOut` also
    # take the r pairs as one batch.)  Under a mesh it runs on row shards, the
    # levels as the encoder stage left them, and the predictions are gathered.
    decodePost = rowStage(_decodePostPlain, _decodePostSharded, (None,) * 6, None)


def loadCheckpoint(raw: dict) -> dict:
    """The reference checkpoint's ``{"encoder": sd, "decoder": sd}`` as one
    state dict with prefixed keys."""
    return {f"{mod}.{k}": v for mod in ("encoder", "decoder") for k, v in raw[mod].items()}


# --------------------------------------------------------------------------
# host-side time embedding + dedupe
# --------------------------------------------------------------------------

hardshrink = lambda k, c: 0 if abs(k - c) < 1e-6 else k


def getEmbWeight(i: int, c: float) -> np.ndarray:
    """Interpolation times for pair i at step c = 1/sf (IFRNet.py:191-192)."""
    return np.arange(-hardshrink(i % c, c), 1 + 1e-6, c, dtype=np.float32)[1:]


def getEmbStruct(t: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """(times, keepFirstCount, keepLastCount) (IFRNet.py:193)."""
    if float(t[-1]) + 1e-6 > 1:
        return (t[:-1], 0, 1)
    return (t, 0, 0)


class EmbtState(InfiniteSource):
    """Per-pair time-embedding source (IFRNet.py:194-225)."""

    def __init__(self, sf: float):
        assert sf >= 1
        self.c = 1.0 / sf
        self.count = 0

    def pop(self, size: int = 1):
        res = [getEmbStruct(getEmbWeight(i, self.c)) for i in range(self.count, self.count + size)]
        if not self.count:
            res[0] = (res[0][0], 1, res[0][2])
        self.count += size
        return res


def _pyrLvl0(item) -> torch.Tensor:
    """Level-0 feature map of a (pyramid, i) reference item (gathered, and
    counted, when the level is row shards)."""
    pyr, i = item
    level = pyr[0]
    if isinstance(level, RowShards):
        sharded.stats["gathers"] += 1
        level = level.gather()
    return level[i]


class Deduper:
    """Cosine-similarity frame dedupe and scene-cut detection
    (IFRNet.py:227-266).  State items are 5-lists (features, embt, frame,
    frameN, mean); features is a (pyramid, i) reference item."""

    def __init__(self, low: float, high: float):
        self.state: Optional[list] = None
        self.low = low
        self.high = high
        self.skips = 0

    def _concat(self, embt):
        self.skips += 1
        s1 = self.state[1]
        newT = np.concatenate([s1[0], np.ones((s1[2],), np.float32) * self.skips, embt[0] + self.skips])
        self.state[1] = (newT, s1[1] + embt[1], embt[2])

    def __call__(self, *args, last=None):
        if args[0] is None:  # flush call: emit the residual final state
            if self.state is None:
                return None
            s, self.state = self.state, None
            if self.skips:
                s[1] = (s[1][0] / (self.skips + 1), s[1][1], s[1][2])
                self.skips = 0
            return [s]
        newState = [a[0] for a in args]  # a batch of 1 from every input
        feats = newState[0]
        embt = newState[1]
        if self.state is None:
            self.state = newState
            return None
        a = _pyrLvl0(self.state[0]).float().reshape(-1)
        b = _pyrLvl0(feats).float().reshape(-1)
        # one transfer to the host for the three numbers
        simNum, n1, n2 = torch.stack([torch.dot(a, b), a.norm(), b.norm()]).tolist()
        sim = simNum / max(n1 * n2, 1e-12)
        if sim > self.high:  # duplicate: fold this frame into the gap
            self._concat(embt)
            if not last:
                return None
        s = self.state
        if sim < self.low:  # scene cut: repeat the first frame instead
            e0 = s[1]
            s[1] = (np.empty((0,), np.float32), e0[1] + len(e0[0]), e0[2])
        if self.skips:
            s[1] = (s[1][0] / (self.skips + 1), s[1][1], s[1][2])
        self.state = newState
        self.skips = 0
        return [s, newState] if last else [s]


# --------------------------------------------------------------------------
# option + graph assembly
# --------------------------------------------------------------------------


class IFRNetOpt(StreamOpt):
    pass


def getOpt(option: dict, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None) -> IFRNetOpt:
    """Step options -> IFRNetOpt with the model loaded from ``modelPaths``
    on the compute device, in ``config.dtype()`` unless ``dtype`` says."""
    from moephoto_tpu_torch.pipeline.registry import modelPath

    size = option["model"][-1]
    opt = IFRNetOpt()
    opt.sf = float(option["sf"])
    opt.dedupe = bool(option.get("dedupe", False))
    opt.dedupeLow = float(option.get("low", 0.5))
    opt.dedupeHigh = float(option.get("high", 0.993))
    opt.ensemble = min(int(option.get("ensemble", 0)), 7)
    device = torch.device(device) if device is not None else config.torchDevice()
    opt.dtype = dtype if dtype is not None else config.dtype()
    raw = torch.load(modelPath(modelPaths[size]), map_location="cpu", weights_only=True)
    model = IFRNet(size)
    model.load_state_dict(loadCheckpoint(raw), strict=True)
    model = model.to(device=device, dtype=opt.dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    opt.model = model
    return opt


# frames per encoder call and frame pairs per decode call
Chunk = 8


def doSlomo(func, node, opt: IFRNetOpt):
    """Assemble the slomo stream graph (reference ``doSlomo``
    IFRNet.py:316-343), with the optional dedupe branch.

    The time-embedding source is consumed with the frame pairs by the
    decode stage (it is infinite, so it never gates scheduling); the
    per-pair embt tuple rides along, so the merge needs no stream of its
    own."""
    load = max(opt.sf - 1, 1)
    nodes = [Node({"IFRNet": "encode"}), Node({"IFRNet": "decode"}, load=load)]
    graph = StreamGraph()
    sinkList: List = []
    model = opt.model
    listBatch = lambda x: x

    def makeEncode(meanDst, normDst):
        def encode(frames, last=None):
            # frames (r, H, W, 3) fp32: the means and normalised frames go
            # straight to their streams; the pyramid items are (pyramid, i)
            # references into the chunk's 4 level tensors
            with torch.inference_mode():
                m, inpN, feats = model.encodeFull(frames)
            meanDst.put(m)
            normDst.put(inpN)
            return [(feats, i) for i in range(frames.shape[0])]

        return encode

    def pairLevels(wins):
        """4 levels of (r, 2, h, w, c) from r windows of (pyramid, i)
        items: per level each column is one run-merged slice, and one
        stack along axis 1 pairs them."""
        def pair(l, part=lambda x: x):
            cols = [stackBatch([RowRef(part(w[s][0][l]), w[s][1]) for w in wins]) for s in (0, 1)]
            return torch.stack(cols, dim=1)

        out = []
        for l in range(4):
            level = wins[0][0][0][l]
            if isinstance(level, RowShards):  # row shards from a sharded encoder stage: shard by shard
                out.append(RowShards([pair(l, lambda x, j=j: x.parts[j]) for j in range(level.n)], level.bounds, 2))
            else:
                out.append(pair(l))
        return out

    def decodePost(featWins, embts, pairs, pairNs, meanPairs, last=None):
        # featWins: r windows [(pyrL, iL), (pyrR, iR)]; embts: r embt
        # tuples; pairs, pairNs (r, 2, H, W, 3); meanPairs (r, 2, 1, 1, 1).
        # A chunk whose pairs all have the same k > 0 (every integer sf)
        # runs as one call on run-merged feature levels; mixed k
        # (fractional sf, dedupe residue) and k = 0 run pair by pair from
        # the pyramid items: the same math.
        ks = [len(e[0]) for e in embts]
        r = len(embts)
        res: List = []
        dev = pairs.device
        with torch.inference_mode():
            if r and ks[0] > 0 and all(k == ks[0] for k in ks):
                t = torch.from_numpy(np.stack([e[0] for e in embts])).to(dev)
                preds = model.decodePost(pairLevels(featWins), t, pairNs, meanPairs, opt.ensemble)
                for i, embt in enumerate(embts):
                    res += [pairs[i, 0].float()] * int(embt[1])
                    res += [preds[i, j] for j in range(ks[0])]
                    res += [pairs[i, 1].float()] * int(embt[2])
                return res
            for i, embt in enumerate(embts):
                res += [pairs[i, 0].float()] * int(embt[1])  # keep-first copies
                if ks[i]:
                    (pyrL, iL), (pyrR, iR) = featWins[i]
                    both = lambda a, b: torch.stack([a[iL], b[iR]])[None]
                    feats = [zipShards(both, pyrL[l], pyrR[l], axis=2) if isinstance(pyrL[l], RowShards)
                             else both(pyrL[l], pyrR[l]) for l in range(4)]
                    t = torch.from_numpy(embt[0][None]).to(dev)
                    preds = model.decodePost(feats, t, pairNs[i : i + 1], meanPairs[i : i + 1], opt.ensemble)
                    res += [preds[0, j] for j in range(ks[i])]
                res += [pairs[i, 1].float()] * int(embt[2])  # keep-last copies
        return res

    opt.embt = EmbtState(opt.sf)
    inp = Stream(name="inp")
    pairRaw = Stream(2, name="pairRaw")
    meanPair = Stream(2, name="meanPair")
    pairN = Stream(2, name="pairN")
    pairFeat = Stream(2, tensor=False, batchFunc=listBatch, name="featPair")
    outS = Stream(store=False, name="pred")
    outS.sink = sinkList

    if opt.dedupe:
        inps = [Stream(name="inps0"), Stream(name="inps2")]
        graph.tee(inp, inps)
        mean1 = Stream(name="mean1")
        inpN1 = Stream(name="inpN1")
        ft1 = Stream(tensor=False, batchFunc=listBatch, name="ft1")
        graph.stage(nodes[0].bindFunc(makeEncode(mean1, inpN1)), [inps[0]], [ft1], size=Chunk)
        dedupeOut = [Stream(tensor=False, batchFunc=listBatch, name=f"dd{i}") for i in range(5)]
        deduper = Deduper(opt.dedupeLow, opt.dedupeHigh)
        graph.stage(deduper, [ft1, opt.embt, inps[1], inpN1, mean1], dedupeOut, flushOnce=True)
        extract = lambda n: (lambda items, last=None: [item[n] for item in items if item[n] is not None])
        emb1 = Stream(tensor=False, batchFunc=listBatch, name="emb1")
        for i, tgt in enumerate((pairFeat, emb1, pairRaw, pairN, meanPair)):
            graph.stage(extract(i), [dedupeOut[i]], [tgt])
        embSource = emb1
    else:
        inps0 = Stream(name="inps0")
        graph.tee(inp, [inps0, pairRaw])
        graph.stage(nodes[0].bindFunc(makeEncode(meanPair, pairN)), [inps0], [pairFeat], size=Chunk)
        embSource = opt.embt

    graph.stage(nodes[1].bindFunc(decodePost), [pairFeat, embSource, pairRaw, pairN, meanPair], [outS],
                size=Chunk)

    def initFunc(o, x):
        o.padF, o.unpadF, size = alignPad(x, 16)
        o.pad = lambda f: o.padF(f)
        h, w_ = x.shape[0], x.shape[1]
        o.unpad = lambda f: f[:h, :w_]
        o.embt.count = o.start
        o.end = 0
        return size

    return makeStreamFunc(func, node, opt, nodes, "slomo", [], initFunc, lambda x: inp.put([x]), graph,
                          sinkList)
