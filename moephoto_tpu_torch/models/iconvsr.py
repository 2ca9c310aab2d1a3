"""IconVSR x4 bidirectional recurrent video super-resolution (reference
``python/videoSR.py``; JAX ``moephoto_tpu/models/iconvsr.py``).

Components: SpyNet, a 6-level pyramid optical flow whose warps go through
:func:`ops.warp.backWarp` (K2); the EDVR keyframe feature extractor, PCD
deformable alignment (4 DCNs per call through :func:`ops.deform.deformConv2d`,
K3) and TSA fusion; backward and forward recurrent trunks with keyframe
fusion; and the pixel-shuffle upsampler.

The stream (:func:`doVSR`) follows the JAX package's graph: the backward
pass runs on chunks of ``BackwardChunk`` frames, each from a fresh zero
state (bounded lookahead); the forward pass carries its state across
chunks; keyframes come every ``RefTime`` frames and at the end of the
stream, and EDVR runs on each keyframe's full ``RefTime``-frame window.
SpyNet runs once per chunk on the chunk's frame pairs, EDVR once per
keyframe clip, the recurrences are Python loops over the chunk.  Each of
these is a profiler span while one records (``progress.span``):
``moe.vsr.edvr`` one keyframe clip's EDVR, ``moe.vsr.spynet`` one chunk's
flows and ``moe.vsr.scan`` one chunk's recurrence (in either direction),
``moe.vsr.up`` one upsampler sub-batch; each backward chunk counts its
EDVR calls and its frames (``moe.count.vsr_keyframes``,
``moe.count.vsr_frames``).

Tensors are NHWC at every function boundary; convolutions run on NCHW
views of them (channels-last in memory on the card).  The flows and the
propagation warps run in fp32, the rest in the model's dtype.

Under ``config.meshShape`` every stage runs row-sharded
(``parallel/temporal.py`` :func:`rowStage`), as the JAX package's
``spyJit``, ``edvrJit``, ``bScanJit``, ``fScanJit`` and ``upJit``: the
frames' rows split at multiples of ``ALIGN``, each conv segment takes a
halo of its stated row reach (``parallel/sharded.py`` :func:`rowSegment`),
SpyNet's and the recurrences' warps go through K2a
(:func:`ops.warp.backWarpSpmd`) and EDVR's four DCNs through K3's tier
(:func:`ops.deform.deformConv2dSpmd`).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.stream import InfiniteSource, Stream, StreamGraph
from moephoto_tpu_torch.models.api import avgPool2d, conv, leakyRelu, maxPool2d, resizeBilinear, sigmoid
from moephoto_tpu_torch.models.blocks import ConvResidualBlocks, ResidualBlockNoBN
from moephoto_tpu_torch.models.streamcommon import StreamOpt, alignPad, makeStreamFunc
from moephoto_tpu_torch.ops.deform import ModulatedDeformConvPack
from moephoto_tpu_torch.ops.warp import backWarp, backWarpSpmd, rowReach
from moephoto_tpu_torch.parallel import sharded
from moephoto_tpu_torch.parallel.mesh import replicaOn
from moephoto_tpu_torch.parallel.sharded import RowShards, rowSegment, zipShards
from moephoto_tpu_torch.parallel.temporal import rowStage
from moephoto_tpu_torch.progress import Node, count, span

RefTime = 7
NumFeat = 64
DeformableGroups = 8
BackwardChunk = 20  # semantic: the backward state restarts every chunk
ForwardChunk = 20  # dispatch granularity only: the forward state crosses chunks
UpSubBatch = 4  # frames per upsampler call, to bound the x4 intermediates

modelPath_ = "model/vsr/IconVSR_Vimeo90K_BDx4-cfcb7e00.pth"

_SPY_MEAN = (0.485, 0.456, 0.406)
_SPY_STD = (0.229, 0.224, 0.225)


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2)


lrelu = lambda x: leakyRelu(x, 0.1)
cat = lambda xs: torch.cat(xs, -1)

# Row-sharded stages.  The frames (padded to 64-row multiples) split at
# multiples of ALIGN rows, so SpyNet's five halvings, EDVR's two stride-2
# levels and TSA's two poolings cut whole rows.  Each segment's halo is its
# row reach in its input's rows:
#   SpyNet's basic module (five 7x7 convs): 15;
#   EDVR's feature extraction (conv_first, five residual blocks): 11; each
#   stride-2 level (a 3x3 stride-2 conv, one input row, and a 3x3 conv at
#   half size, two): 3, rounded up to an even count so the crop is whole
#   rows; a PCD level's offset convs and conv_offset: 3 at L3 (two convs and
#   conv_offset), 4 at L2 and L1 (three and conv_offset), the cascade 3;
#   feat_conv 1; the 2x resizes of the offsets and features 1;
#   TSA (a 3x3 temporal conv: 1; two 3x3 stride-2 poolings: 1 and 2; two
#   3x3 convs at 1/4: 8; the 2x resize back to 1/2: 4; to full size: 2; the
#   last 3x3 conv: 1): 19, rounded up to a multiple of 4 so both poolings
#   keep their phase;
#   a recurrence step (the fusion 3x3 conv at keyframes, then the trunk's
#   input conv and two 3x3 convs a residual block): 1 + 1 + 2 numBlocks;
#   the upsampler (3x3 convs at 1x, 2x, 4x, 4x: 1 + 1/2 + 1/4 + 1/4; the x4
#   bilinear resize of the frame: 1): 2, at scale 4.
# The up-sampled flow of each SpyNet level is computed whole (an
# align_corners resize maps rows by the global sizes) and cut at the
# level's bounds.  A segment whose input lies at GATHER_FROM of the frame's
# rows or coarser runs gathered, at any size (SpyNet's levels at 1/4 and
# coarser, EDVR's L3 segments), as IFRNet's coarse levels do since the flows
# and offsets estimated there move the whole frame when a bf16 rounding
# differs; a shard shorter than a segment's halo runs it gathered too.  TSA
# runs gathered (GATHER_TSA; the tests switch it off to hold TSA's halo):
# cuDNN picks its algorithm by shape, and in bf16 at 640x360 TSA on shards
# of 192 and 96 rows rounded 0.115 % of its outputs one ulp apart from the
# whole clip's, which the recurrences carry into every frame; every other
# segment rounded none apart there (PERF.md; ``sharded.checkingSegments``).
ALIGN = 32
GATHER_FROM = Fraction(1, 4)
GATHER_TSA = True
SPY_HALO = 15
EXTRACT_HALO = 11
DOWN_HALO = 4
TSA_HALO = 20
UP_HALO = 2


def coarse(frac) -> bool:
    """Whether a segment whose input is at ``frac`` of the frame's rows runs gathered."""
    return Fraction(frac) <= GATHER_FROM


def propWarp(feat, flow, reach: Optional[int] = None):
    """The recurrences' feature warp: ``backWarp`` in fp32 with zeros
    padding (the reference's default), back to the features' dtype.  Row
    shards take K2a (:func:`ops.warp.backWarpSpmd`), ``reach`` the flows'
    row reach read once for the chunk."""
    if isinstance(feat, RowShards):
        dtype = feat.parts[0].dtype
        return backWarpSpmd(feat.map(lambda p: p.float()), flow, "zeros", reach).map(lambda p: p.to(dtype))
    return backWarp(feat.float(), flow, "zeros").to(feat.dtype)


def catRows(xs):
    """Tensors (or row shards with one set of bounds) concatenated on axis 0."""
    return zipShards(lambda *ps: torch.cat(ps), *xs) if isinstance(xs[0], RowShards) else torch.cat(xs)


def catC(xs):
    """Tensors (or row shards with one set of bounds) concatenated on the channels."""
    return zipShards(lambda *ps: cat(ps), *xs) if isinstance(xs[0], RowShards) else cat(xs)


def seg(fn, x, halo: int, scale=1, gather: bool = False):
    """``fn`` on a tensor, or on row shards a :func:`rowSegment` of ``halo`` rows."""
    return rowSegment(fn, x, halo, scale, gather) if isinstance(x, RowShards) else fn(x)


def each(fn, x, axis: Optional[int] = None):
    """``fn`` on a tensor, or on every part of row shards (their rows moved to ``axis``)."""
    return x.map(fn, axis) if isinstance(x, RowShards) else fn(x)


def rowsOf(x, t: int):
    """Item ``t`` of axis 0 kept as a batch of one (row shards stay row shards)."""
    return x.map(lambda p: p[t : t + 1]) if isinstance(x, RowShards) else x[t : t + 1]


def likeShards(x, like: RowShards):
    """``x`` as row shards at ``like``'s bounds on axis 1 (None and row
    shards as they are)."""
    return x if x is None or isinstance(x, RowShards) else RowShards.split(x, like.devices, 1, bounds=like.bounds)


def toFloat(x):
    return x.map(lambda p: p.float()) if isinstance(x, RowShards) else x.float()


def on(module, v: torch.Tensor):
    """``module`` with its weights on ``v``'s device (a shard's card)."""
    return replicaOn(module, v.device)


class SpyNet(nn.Module):
    """SpyNet (videoSR.py:87-137) in the fine 7x7 form: keys
    ``basic_module.{level}.{0,2,4,6,8}``."""

    def __init__(self):
        super().__init__()
        cs = (8, 32, 64, 32, 16, 2)
        layers = lambda: [m for i in range(5) for m in (_conv(cs[i], cs[i + 1], 7), nn.ReLU())][:-1]
        self.basic_module = nn.ModuleList(nn.Sequential(*layers()) for _ in range(6))

    @staticmethod
    def _normalised(pair: torch.Tensor, side: int) -> torch.Tensor:
        mean = torch.tensor(_SPY_MEAN, device=pair.device).to(pair.dtype)
        std = torch.tensor(_SPY_STD, device=pair.device).to(pair.dtype)
        return (pair[:, side] - mean) / std

    def _up(self, flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return resizeBilinear(flow, h, w, align_corners=True) * 2.0

    def _level(self, level: int, ref: torch.Tensor, supp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        up = self._up(flow, ref.shape[1], ref.shape[2])
        warped = backWarp(supp, up, "border")
        return conv(on(self.basic_module[level], ref), cat([ref, warped, up])) + up

    def _forwardPlain(self, pair: torch.Tensor) -> torch.Tensor:
        ref = [self._normalised(pair, 0)]
        supp = [self._normalised(pair, 1)]
        for _ in range(5):
            ref.insert(0, avgPool2d(ref[0], 2, 2, count_include_pad=False))
            supp.insert(0, avgPool2d(supp[0], 2, 2, count_include_pad=False))
        B, H0, W0, _ = ref[0].shape
        flow = pair.new_zeros((B, H0 // 2, W0 // 2, 2))
        for level in range(6):
            flow = self._level(level, ref[level], supp[level], flow)
        return flow

    def _forwardSharded(self, pair: RowShards) -> RowShards:
        """The pyramid on row shards (the pair's rows on axis 2): each level's
        up-sampled flow computed whole and cut at the level's bounds, the warp
        through K2a, the basic module a segment of SPY_HALO rows; a level at
        GATHER_FROM of the rows or coarser runs gathered."""
        down = lambda x: rowSegment(lambda v: avgPool2d(v, 2, 2, count_include_pad=False), x, 0, Fraction(1, 2))
        ref = [pair.map(lambda p: self._normalised(p, 0), axis=1)]
        supp = [pair.map(lambda p: self._normalised(p, 1), axis=1)]
        for _ in range(5):
            ref.insert(0, down(ref[0]))
            supp.insert(0, down(supp[0]))
        B, W0 = pair.shape[0], ref[0].shape[2]
        flow = ref[0].parts[0].new_zeros((B, ref[0].rows // 2, W0 // 2, 2))
        for level in range(6):
            r, s = ref[level], supp[level]
            whole = flow.gather() if isinstance(flow, RowShards) else flow
            sharded.stats["gathers"] += 1
            if coarse(Fraction(r.rows, pair.rows)):
                flow = self._level(level, r.gather(), s.gather(), whole)
                continue
            up = RowShards.split(self._up(whole, r.rows, r.shape[2]), r.devices, 1, bounds=r.bounds)
            x = catC([r, backWarpSpmd(s, up, "border"), up])
            flow = zipShards(lambda a, b: a + b,
                             rowSegment(lambda v: conv(on(self.basic_module[level], v), v), x, SPY_HALO), up)
        return flow if isinstance(flow, RowShards) else RowShards.split(flow, pair.devices, 1, bounds=pair.bounds)

    # pair (B, 2, H, W, 3), H and W multiples of 64 -> flow (B, H, W, 2) in the
    # pair's dtype.  Under a mesh the pair's rows (axis 2) shard and the flow
    # stays row shards (axis 1).
    forward = rowStage(_forwardPlain, _forwardSharded, (None, 2), (1,), align=ALIGN)


class PCDAlignment(nn.Module):
    """PCD alignment (videoSR.py:139-220): a 3-level pyramid cascade of
    deformable convs, then a cascading one at full resolution."""

    def __init__(self, c: int = NumFeat, dg: int = DeformableGroups):
        super().__init__()
        levels = ("l3", "l2", "l1")
        self.offset_conv1 = nn.ModuleDict({lv: _conv(2 * c, c) for lv in levels})
        self.offset_conv2 = nn.ModuleDict({lv: _conv(c if lv == "l3" else 2 * c, c) for lv in levels})
        self.offset_conv3 = nn.ModuleDict({lv: _conv(c, c) for lv in levels[1:]})
        self.dcn_pack = nn.ModuleDict({lv: ModulatedDeformConvPack(c, c, dg) for lv in levels})
        self.feat_conv = nn.ModuleDict({lv: _conv(2 * c, c) for lv in levels[1:]})
        self.cas_offset_conv1 = _conv(2 * c, c)
        self.cas_offset_conv2 = _conv(c, c)
        self.cas_dcnpack = ModulatedDeformConvPack(c, c, dg)

    def forward(self, nbr: List, ref: List):
        """nbr, ref: the 3 levels, full resolution first, each NHWC, or each
        row shards on axis 1: then each level's offset convs with
        conv_offset are one segment, the DCN goes through K3's tier,
        feat_conv and the 2x resizes are segments of their own, and L3's
        segments run gathered (GATHER_FROM)."""
        c = nbr[0].shape[-1]
        upOffset = upFeat = feat = None
        for i in (3, 2, 1):
            lv, gather = f"l{i}", coarse(Fraction(1, 2 ** (i - 1)))
            pack = self.dcn_pack[lv]

            def offsets(v, i=i, lv=lv, pack=pack):
                offset = lrelu(conv(on(self.offset_conv1[lv], v), v[..., : 2 * c]))
                if i == 3:
                    offset = lrelu(conv(on(self.offset_conv2[lv], v), offset))
                else:
                    offset = lrelu(conv(on(self.offset_conv2[lv], v), cat([offset, v[..., 2 * c :]])))
                    offset = lrelu(conv(on(self.offset_conv3[lv], v), offset))
                return cat([offset, on(pack, v).offsetsOf(offset)])

            args = [nbr[i - 1], ref[i - 1]] + ([upOffset] if i < 3 else [])
            out = seg(offsets, catC(args), 3 if i == 3 else 4, gather=gather)
            offset = each(lambda p: p[..., :c], out)
            feat = pack.sample(nbr[i - 1], each(lambda p: p[..., c:], out))
            if i < 3:
                feat = seg(lambda v, lv=lv: conv(on(self.feat_conv[lv], v), v), catC([feat, upFeat]), 1)
            if i > 1:
                feat = each(lrelu, feat)
                up = seg(lambda v: resizeBilinear(v, 2 * v.shape[1], 2 * v.shape[2]), catC([offset, feat]), 1, 2,
                         gather)
                upOffset, upFeat = each(lambda p: p[..., :c] * 2.0, up), each(lambda p: p[..., c:], up)

        def casOffsets(v):
            offset = lrelu(conv(on(self.cas_offset_conv1, v), v))
            offset = lrelu(conv(on(self.cas_offset_conv2, v), offset))
            return on(self.cas_dcnpack, v).offsetsOf(offset)

        return each(lrelu, self.cas_dcnpack.sample(feat, seg(casOffsets, catC([feat, ref[0]]), 3)))


class TSAFusion(nn.Module):
    """Temporal and spatial attention fusion (videoSR.py:222-307)."""

    def __init__(self, c: int = NumFeat, nFrames: int = RefTime):
        super().__init__()
        self.temporal_attn1, self.temporal_attn2 = _conv(c, c), _conv(c, c)
        self.feat_fusion = _conv(nFrames * c, c, 1)
        self.spatial_attn1 = _conv(nFrames * c, c, 1)
        self.spatial_attn2 = _conv(2 * c, c, 1)
        self.spatial_attn3 = _conv(c, c)
        self.spatial_attn4 = _conv(c, c, 1)
        self.spatial_attn5 = _conv(c, c)
        self.spatial_attn_l1 = _conv(c, c, 1)
        self.spatial_attn_l2 = _conv(2 * c, c)
        self.spatial_attn_l3 = _conv(c, c)
        self.spatial_attn_add1 = _conv(c, c, 1)
        self.spatial_attn_add2 = _conv(c, c, 1)

    def forward(self, aligned: torch.Tensor, center: int) -> torch.Tensor:
        """aligned (B, N, H, W, C), H and W multiples of 4 -> (B, H, W, C)."""
        B, N, H, W, C = aligned.shape
        embRef = conv(self.temporal_attn1, aligned[:, center])
        emb = conv(self.temporal_attn2, aligned.reshape(B * N, H, W, C)).reshape(B, N, H, W, -1)
        corrProb = sigmoid((emb * embRef[:, None]).sum(-1))[..., None]  # (B, N, H, W, 1)
        # (B, H, W, N C), the reference's channel order [frame 0 C, frame 1 C, ...]
        flat = (aligned * corrProb).permute(0, 2, 3, 1, 4).reshape(B, H, W, N * C)
        feat = lrelu(conv(self.feat_fusion, flat))
        attn = lrelu(conv(self.spatial_attn1, flat))
        attn = lrelu(conv(self.spatial_attn2, cat([maxPool2d(attn, 3, 2, 1), avgPool2d(attn, 3, 2, 1)])))
        level = lrelu(conv(self.spatial_attn_l1, attn))
        level = lrelu(conv(self.spatial_attn_l2, cat([maxPool2d(level, 3, 2, 1), avgPool2d(level, 3, 2, 1)])))
        level = lrelu(conv(self.spatial_attn_l3, level))
        level = resizeBilinear(level, 2 * level.shape[1], 2 * level.shape[2])
        attn = lrelu(conv(self.spatial_attn3, attn)) + level
        attn = lrelu(conv(self.spatial_attn4, attn))
        attn = conv(self.spatial_attn5, resizeBilinear(attn, 2 * attn.shape[1], 2 * attn.shape[2]))
        attnAdd = conv(self.spatial_attn_add2, lrelu(conv(self.spatial_attn_add1, attn)))
        return feat * sigmoid(attn) * 2 + attnAdd


class EDVR(nn.Module):
    """EDVR keyframe feature extractor (videoSR.py:324-379).  ``calls``
    counts its forward calls (4 DCNs each)."""

    def __init__(self, c: int = NumFeat, nFrames: int = RefTime):
        super().__init__()
        self.conv_first = _conv(3, c)
        self.feature_extraction = nn.Sequential(*[ResidualBlockNoBN(c) for _ in range(5)])
        self.conv_l2_1, self.conv_l2_2 = _conv(c, c, 3, 2), _conv(c, c)
        self.conv_l3_1, self.conv_l3_2 = _conv(c, c, 3, 2), _conv(c, c)
        self.pcd_align = PCDAlignment(c)
        self.fusion = TSAFusion(c, nFrames)
        self.calls = 0

    def _extract(self, x: torch.Tensor) -> torch.Tensor:
        return conv(on(self.feature_extraction, x), lrelu(conv(on(self.conv_first, x), x)))

    @staticmethod
    def _down(first, second, x: torch.Tensor) -> torch.Tensor:
        return lrelu(conv(on(second, x), lrelu(conv(on(first, x), x))))

    @staticmethod
    def _centre(lv: torch.Tensor, B: int, N: int) -> torch.Tensor:
        s = lv.shape[1:]
        return lv.reshape(B, N, *s)[:, N // 2 : N // 2 + 1].expand(B, N, *s).reshape(B * N, *s)

    def _fuse(self, aligned: torch.Tensor, B: int, N: int) -> torch.Tensor:
        return on(self.fusion, aligned)(aligned.reshape(B, N, *aligned.shape[1:]), N // 2)

    def _forward(self, x):
        """x (B, N, H, W, 3), or row shards of it on axis 2: then the
        feature extraction, both stride-2 levels, PCD and TSA (gathered
        while GATHER_TSA) are segments of their stated reach, and the
        features (B, H, W, C) stay row shards on axis 1."""
        self.calls += 1
        B, N = x.shape[:2]
        flat = each(lambda p: p.reshape(B * N, *p.shape[2:]), x, axis=1)
        l1 = seg(self._extract, flat, EXTRACT_HALO)
        l2 = seg(lambda v: self._down(self.conv_l2_1, self.conv_l2_2, v), l1, DOWN_HALO, Fraction(1, 2))
        l3 = seg(lambda v: self._down(self.conv_l3_1, self.conv_l3_2, v), l2, DOWN_HALO, Fraction(1, 2),
                 coarse(Fraction(1, 2)))
        nbr = [l1, l2, l3]
        aligned = self.pcd_align(nbr, [each(lambda p: self._centre(p, B, N), lv) for lv in nbr])
        return seg(lambda v: self._fuse(v, B, N), aligned, TSA_HALO, gather=GATHER_TSA)

    # x (B, N, H, W, 3), H and W multiples of 4 -> (B, H, W, C).  The N
    # neighbours of each clip align as one batch of B N, as in JAX.  Under a
    # mesh the clip's rows (axis 2) shard and the features stay row shards.
    forward = rowStage(_forward, _forward, (None, 2), (1,), align=ALIGN)


class Upsample(nn.Sequential):
    """Upsampler (videoSR.py:313-322): conv, shuffle x2, lrelu, conv,
    shuffle x2, lrelu, conv, lrelu, conv; keys ``0``, ``3``, ``6``, ``8``.
    On NCHW."""

    def __init__(self, c: int = NumFeat):
        super().__init__(_conv(c, 4 * c), nn.PixelShuffle(2), nn.LeakyReLU(0.1), _conv(c, 4 * c),
                         nn.PixelShuffle(2), nn.LeakyReLU(0.1), _conv(c, c), nn.LeakyReLU(0.1), _conv(c, 3))


def trunkBlocks(sd: dict) -> int:
    """The residual block count of the trunks, from a flat state dict."""
    return len({k.split(".")[2] for k in sd if k.startswith("backward_trunk.2.")})


class IconVSR(nn.Module):
    """IconVSR's modules under the checkpoint's module names."""

    def __init__(self, numBlocks: int = 30):
        super().__init__()
        self.spynet = SpyNet()
        self.edvr = EDVR()
        self.backward_trunk = ConvResidualBlocks(NumFeat + 3, NumFeat, numBlocks)
        self.forward_trunk = ConvResidualBlocks(2 * NumFeat + 3, NumFeat, numBlocks)
        self.backward_fusion = _conv(2 * NumFeat, NumFeat)
        self.forward_fusion = _conv(2 * NumFeat, NumFeat)
        self.upsample = Upsample()

    @staticmethod
    def _step(fusion, trunk, featProp: torch.Tensor, kf: Optional[torch.Tensor], others) -> torch.Tensor:
        """One recurrence step: the keyframe fusion when ``kf`` is given, then
        the trunk on cat(others + [featProp])."""
        if kf is not None:
            featProp = conv(fusion, cat([featProp, kf]))
        return conv(trunk, cat(list(others) + [featProp]))

    def _stepSharded(self, fusion, trunk, featProp: RowShards, kf, others) -> RowShards:
        """:meth:`_step` on row shards: one segment of the step's reach (the
        fusion's 3x3 conv, the trunk's input conv and two 3x3 convs a block)."""
        pieces = [likeShards(p, featProp) for p in [featProp] + ([kf] if kf is not None else []) + list(others)]
        k = len(pieces) - len(others)

        def step(v):
            ps = v.split([p.shape[-1] for p in pieces], -1)
            return self._step(on(fusion, v), on(trunk, v), ps[0], ps[1] if k == 2 else None, ps[k:])

        return rowSegment(step, catC(pieces), k + 2 * len(trunk[2]))

    def _backwardScanPlain(self, inp, flow, warps, kfs) -> torch.Tensor:
        T, H, W, _ = inp.shape
        featProp = inp.new_zeros((1, H, W, NumFeat))
        outs = [None] * T
        for t in reversed(range(T)):
            if warps[t]:
                featProp = propWarp(featProp, flow[t : t + 1])
            featProp = self._step(self.backward_fusion, self.backward_trunk, featProp, kfs[t], [inp[t : t + 1]])
            outs[t] = featProp
        return torch.cat(outs)

    def _backwardScanSharded(self, inp: RowShards, flow: RowShards, warps, kfs) -> RowShards:
        """The backward recurrence on row shards: the flows' row reach read
        once for the chunk, each step's warp through K2a and its fusion and
        trunk one segment (:meth:`_stepSharded`)."""
        reach = rowReach(flow.parts, 1)
        featProp = inp.map(lambda p: p.new_zeros((1,) + p.shape[1:3] + (NumFeat,)))
        outs = [None] * inp.shape[0]
        for t in reversed(range(inp.shape[0])):
            if warps[t]:
                featProp = propWarp(featProp, rowsOf(flow, t), reach)
            featProp = self._stepSharded(self.backward_fusion, self.backward_trunk, featProp, kfs[t],
                                         [rowsOf(inp, t)])
            outs[t] = featProp
        return catRows(outs)

    # Backward recurrence over one chunk (videoSR.py:415-431), last frame first,
    # from a zero state: inp (T, H, W, 3) in the model's dtype, flow (T, H, W, 2)
    # fp32, ``warps[t]`` whether frame t has a flow, ``kfs[t]`` its keyframe
    # features (1, H, W, C) or None -> (T, H, W, C).  Under a mesh inp and flow
    # shard (or come as row shards) and so do the keyframe features and the
    # outputs.
    backwardScan = rowStage(_backwardScanPlain, _backwardScanSharded, (None, 1, 1, None, None), (1,), align=ALIGN)

    def _forwardScanPlain(self, featProp, inp, bwd, flow, warps, kfs):
        outs = []
        for t in range(inp.shape[0]):
            if warps[t]:
                featProp = propWarp(featProp, flow[t : t + 1])
            featProp = self._step(self.forward_fusion, self.forward_trunk, featProp, kfs[t],
                                  [inp[t : t + 1], bwd[t]])
            outs.append(featProp)
        return torch.cat(outs), featProp

    def _forwardScanSharded(self, featProp, inp: RowShards, bwd, flow: RowShards, warps, kfs):
        """The forward recurrence on row shards, as the backward one."""
        featProp = likeShards(featProp, inp)
        reach = rowReach(flow.parts, 1)
        outs = []
        for t in range(inp.shape[0]):
            if warps[t]:
                featProp = propWarp(featProp, rowsOf(flow, t), reach)
            featProp = self._stepSharded(self.forward_fusion, self.forward_trunk, featProp, kfs[t],
                                         [rowsOf(inp, t), bwd[t]])
            outs.append(featProp)
        return catRows(outs), featProp

    # Forward recurrence (videoSR.py:446-460) from ``featProp`` (1, H, W, C),
    # with ``bwd[t]`` the backward pass's features of frame t (1, H, W, C) ->
    # (outputs (T, H, W, C), the state after the last frame).  Under a mesh
    # both outputs stay row shards.
    forwardScan = rowStage(_forwardScanPlain, _forwardScanSharded, (None, None, 1, None, 1, None, None), (1, 1),
                           align=ALIGN)

    def _upsample(self, v: torch.Tensor) -> torch.Tensor:
        f, i = v[..., :NumFeat], v[..., NumFeat:]
        up = resizeBilinear(i, 4 * i.shape[1], 4 * i.shape[2])
        return conv(on(self.upsample, v), f).float() + up.float()

    def _upsampleChunkPlain(self, inp: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        outs = []
        for s in range(0, inp.shape[0], UpSubBatch):
            with span("moe.vsr.up"):
                outs.append(self._upsample(cat([feat[s : s + UpSubBatch], inp[s : s + UpSubBatch]])))
        return torch.cat(outs)

    def _upsampleChunkSharded(self, inp: RowShards, feat: RowShards) -> RowShards:
        """The upsampler on row shards, each sub-batch a segment of UP_HALO
        rows at scale 4."""
        outs = []
        for s in range(0, inp.shape[0], UpSubBatch):
            with span("moe.vsr.up"):
                sub = zipShards(lambda a, b: cat([a[s : s + UpSubBatch], b[s : s + UpSubBatch]]), feat, inp)
                outs.append(rowSegment(self._upsample, sub, UP_HALO, 4))
        return catRows(outs)

    # (T, H, W, 3), (T, H, W, C) -> (T, 4H, 4W, 3) fp32: the upsampler plus the
    # bilinear x4 of the input, ``UpSubBatch`` frames a call.  Under a mesh the
    # rows shard and the frames are gathered.
    upsampleChunk = rowStage(_upsampleChunkPlain, _upsampleChunkSharded, (None, 1, 1), None, align=ALIGN)


# --------------------------------------------------------------------------
# keyframe marker, option, host-side packing
# --------------------------------------------------------------------------


class KeyFrameState(InfiniteSource):
    """Marks every ``window``-th frame, and the last frame of each pop, as
    a keyframe (videoSR.py:381-401)."""

    def __init__(self, window: int):
        self.window = window
        self.count = 0

    def pop(self, size: int = 1):
        res = np.zeros((size,), bool)
        res[-self.count % self.window :: self.window] = True
        res[-1] = True
        self.count += size
        return res


class VSROpt(StreamOpt):
    pass


def getOpt(option: Optional[dict] = None, device: Optional[torch.device] = None,
            dtype: Optional[torch.dtype] = None) -> VSROpt:
    """The VSR step's option: IconVSR loaded from the nested per-module
    checkpoint ``{module: state_dict}`` at ``modelPath_``, on the compute
    device, in ``config.dtype()`` unless ``dtype`` says.  The trunks'
    block count comes from the checkpoint's keys; keys the model does not
    use (buffers of the reference's modules) are ignored, a key it needs
    and does not find raises."""
    from moephoto_tpu_torch.pipeline.registry import modelPath

    opt = VSROpt()
    device = torch.device(device) if device is not None else config.torchDevice()
    opt.dtype = dtype if dtype is not None else config.dtype()
    raw = torch.load(modelPath(modelPath_), map_location="cpu", weights_only=True)
    sd = {f"{mod}.{k}": v for mod, msd in raw.items() for k, v in msd.items()}
    model = IconVSR(trunkBlocks(sd))
    missing = model.load_state_dict(sd, strict=False).missing_keys
    if missing:
        raise KeyError(f"IconVSR checkpoint lacks {missing[:4]}{' ...' if len(missing) > 4 else ''}")
    model = model.to(device=device, dtype=opt.dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    opt.model = model
    return opt


def _row(item):
    """A lazy (ref, row) stream item as its row kept as a batch of one (row
    shards stay row shards), or None."""
    return None if item is None else rowsOf(item[0], item[1])


def _stackPairs(items, like: torch.Tensor, dtype) -> torch.Tensor:
    """(n, 2, H, W, 3) pair batch from window items [frame A, frame B], a
    None as a zero pair (its flow is never used), built column-wise."""
    zero = torch.zeros_like(like)
    return torch.stack([torch.stack([zero if it is None else it[s] for it in items]).to(dtype) for s in (0, 1)],
                       dim=1)


def doVSR(func, node, opt: VSROpt):
    """Assemble the VSR stream graph (reference ``doVSR`` videoSR.py:502-541,
    as the JAX package's)."""
    nodes = [Node({"IconVSR": key}) for key in ("KeyframeFeature", "Flow", "Backward", "FlowF", "Forward")]
    graph = StreamGraph()
    sinkList: List = []
    model = opt.model

    def kfStage(windows, isKey, last=None):
        # each keyframe's RefTime-frame clip (a host list) or None; EDVR
        # runs on the clips inside the backward stage
        return [list(w) if (b and len(w) == RefTime) else None for w, b in zip(windows, isKey)]

    tailState = {"flowNone": False, "backPad": False}

    def calcFlowBackward(pairs, last=None):
        # item bookkeeping: SpyNet runs on the pairs in the backward stage
        out: List = list(pairs) if pairs is not None else []
        if last and not tailState["flowNone"]:
            out.append(None)  # no flow past the final frame (videoSR.py:411-414)
            tailState["flowNone"] = True
        return out

    fwdState = {"first": True}

    def calcFlowForward(pairs, last=None):
        out: List = []
        if fwdState["first"]:
            out.append(None)
            pairs = pairs[1:]
            fwdState["first"] = False
        out.extend(pairs)
        return out

    def calcBackward(inp, flowInp, keyframeClips, last=None):
        if inp is None:  # flush call: only the tail pads
            if tailState["backPad"]:
                return None
            tailState["backPad"] = True
            return [None, None]
        # a chunk is at most BackwardChunk frames: the stage pops no more
        n = inp.shape[0]
        kfPos = [i for i, c in enumerate(keyframeClips[:n]) if c is not None]
        featItems: List = [None] * n
        warps = [True] * n
        warps[-1] = not last  # no flow past the final frame
        count("vsr_keyframes", len(kfPos))
        count("vsr_frames", n)
        with torch.inference_mode():
            if kfPos:
                clips = torch.stack([f for i in kfPos for f in keyframeClips[i]]).to(opt.dtype)
                clips = clips.reshape((-1, RefTime) + clips.shape[1:])
                feats = []
                for j in range(clips.shape[0]):
                    with span("moe.vsr.edvr"):
                        feats.append(model.edvr(clips[j : j + 1]))
                kfFeats = catRows(feats)
                for rank, i in enumerate(kfPos):
                    featItems[i] = (kfFeats, rank)
            with span("moe.vsr.spynet"):
                flows = toFloat(model.spynet(_stackPairs(flowInp[:n], inp[0], opt.dtype)))
            with span("moe.vsr.scan"):
                outs = model.backwardScan(inp.to(opt.dtype), flows, warps, [_row(it) for it in featItems])
        keyframeFeatFwd.put(featItems)
        out = [(outs, i) for i in range(n)]
        if last and not tailState["backPad"]:
            out.extend([None, None])  # so the tail windows fill (videoSR.py:420-421)
            tailState["backPad"] = True
        return out

    forwardState = {"featProp": None}

    def calcForward(inp, flowInp, keyframeFeat, backward, last=None):
        # forward recurrence and upsampler: the final frames go to the sink
        n, h, w = inp.shape[0], inp.shape[1], inp.shape[2]
        with torch.inference_mode():
            featProp = forwardState["featProp"]
            if featProp is None:
                featProp = inp.new_zeros((1, h, w, NumFeat), dtype=opt.dtype)
            with span("moe.vsr.spynet"):
                flows = toFloat(model.spynet(_stackPairs(flowInp[:n], inp[0], opt.dtype).flip(1)))  # reversed pairs
            x = inp.to(opt.dtype)
            # each backward window's first item is a real frame's (outputs, row)
            with span("moe.vsr.scan"):
                feats, featProp = model.forwardScan(featProp, x, [_row(b[0]) for b in backward[:n]], flows,
                                                    [f is not None for f in flowInp[:n]],
                                                    [_row(it) for it in keyframeFeat[:n]])
            out = model.upsampleChunk(x, feats)
        forwardState["featProp"] = featProp
        oh, ow = opt.outHW
        out = out[:, :oh, :ow]  # the 64-align pad, cropped once for the chunk
        return [out[i] for i in range(n)]

    listB = lambda x: x
    inp = Stream(name="inp")
    inp1 = Stream(name="inp1")
    backwardInp = Stream(name="backwardInp")
    # window items are [frame A, frame B] lists; the stages batch them
    flowInp = Stream(2, tensor=False, batchFunc=listB, name="flowInp")
    flowForwardInp = Stream(tensor=False, batchFunc=listB, name="flowForwardInp").setPadding(1)
    flowBackwardInp = Stream(tensor=False, batchFunc=listB, name="flowBackwardInp")
    isKeyFrame = KeyFrameState(RefTime)
    keyframeFeatureInp = Stream(RefTime, tensor=False, reserve=1, batchFunc=listB, name="kfInp")
    keyframeClipsS = Stream(tensor=False, batchFunc=listB, name="kfClips")
    # keyframe features, made in the backward stage and put here by it as
    # lazy (ref, row) items for the forward fusion
    keyframeFeatFwd = Stream(tensor=False, batchFunc=listB, name="kfFeatF")
    flowBackward = Stream(tensor=False, batchFunc=listB, name="flowB")
    backward = Stream(3, tensor=False, batchFunc=listB, name="backward")
    flowForward = Stream(tensor=False, batchFunc=listB, name="flowF")
    upsampleS = Stream(store=False, name="up")
    upsampleS.sink = sinkList

    graph.tee(inp, [inp1, flowInp, backwardInp])
    graph.tee(flowInp, [flowForwardInp, flowBackwardInp])
    # whole spans, so the backward stage sees every keyframe clip of its chunk
    graph.stage(nodes[0].bindFunc(kfStage), [keyframeFeatureInp, isKeyFrame], [keyframeClipsS], size=BackwardChunk)
    graph.stage(nodes[1].bindFunc(calcFlowBackward), [flowBackwardInp], [flowBackward], size=BackwardChunk,
                flushOnce=True)
    graph.stage(nodes[2].bindFunc(calcBackward), [backwardInp, flowBackward, keyframeClipsS], [backward],
                size=BackwardChunk, flushOnce=True)
    graph.stage(nodes[3].bindFunc(calcFlowForward), [flowForwardInp], [flowForward], size=ForwardChunk)
    graph.stage(nodes[4].bindFunc(calcForward), [inp1, flowForward, keyframeFeatFwd, backward], [upsampleS],
                size=ForwardChunk)

    def initFunc(o, x):
        o.padF, o.unpadF, size = alignPad(x, 64)
        o.pad = lambda f: o.padF(f)
        h, w_ = x.shape[0], x.shape[1]
        o.outHW = (h * 4, w_ * 4)  # calcForward crops each chunk to this
        o.unpad = lambda f: f[: h * 4, : w_ * 4]
        return size

    def pushFunc(x):
        if opt.i + opt.startPadding >= RefTime >> 1:
            inp.put([x])
        keyframeFeatureInp.put([x])

    return makeStreamFunc(func, node, opt, nodes, "VSR", [keyframeFeatureInp], initFunc, pushFunc, graph,
                          sinkList)
