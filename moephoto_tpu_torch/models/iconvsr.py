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
keyframe clip, the recurrences are Python loops over the chunk.

Tensors are NHWC at every function boundary; convolutions run on NCHW
views of them (channels-last in memory on the card).  The flows and the
propagation warps run in fp32, the rest in the model's dtype.
"""

from __future__ import annotations

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
from moephoto_tpu_torch.ops.warp import backWarp
from moephoto_tpu_torch.progress import Node

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


def propWarp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The recurrences' feature warp: ``backWarp`` in fp32 with zeros
    padding (the reference's default), back to the features' dtype."""
    return backWarp(feat.float(), flow, "zeros").to(feat.dtype)


class SpyNet(nn.Module):
    """SpyNet (videoSR.py:87-137) in the fine 7x7 form: keys
    ``basic_module.{level}.{0,2,4,6,8}``."""

    def __init__(self):
        super().__init__()
        cs = (8, 32, 64, 32, 16, 2)
        layers = lambda: [m for i in range(5) for m in (_conv(cs[i], cs[i + 1], 7), nn.ReLU())][:-1]
        self.basic_module = nn.ModuleList(nn.Sequential(*layers()) for _ in range(6))

    def forward(self, pair: torch.Tensor) -> torch.Tensor:
        """pair (B, 2, H, W, 3), H and W multiples of 64 -> flow (B, H, W, 2)
        in the pair's dtype."""
        mean = torch.tensor(_SPY_MEAN, device=pair.device).to(pair.dtype)
        std = torch.tensor(_SPY_STD, device=pair.device).to(pair.dtype)
        ref = [(pair[:, 0] - mean) / std]
        supp = [(pair[:, 1] - mean) / std]
        for _ in range(5):
            ref.insert(0, avgPool2d(ref[0], 2, 2, count_include_pad=False))
            supp.insert(0, avgPool2d(supp[0], 2, 2, count_include_pad=False))
        B, H0, W0, _ = ref[0].shape
        flow = pair.new_zeros((B, H0 // 2, W0 // 2, 2))
        for level in range(6):
            h, w = ref[level].shape[1], ref[level].shape[2]
            up = resizeBilinear(flow, h, w, align_corners=True) * 2.0
            warped = backWarp(supp[level], up, "border")
            flow = conv(self.basic_module[level], cat([ref[level], warped, up])) + up
        return flow


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

    def forward(self, nbr: List[torch.Tensor], ref: List[torch.Tensor]) -> torch.Tensor:
        """nbr, ref: the 3 levels, full resolution first, each NHWC."""
        upOffset = upFeat = feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            offset = lrelu(conv(self.offset_conv1[lv], cat([nbr[i - 1], ref[i - 1]])))
            if i == 3:
                offset = lrelu(conv(self.offset_conv2[lv], offset))
            else:
                offset = lrelu(conv(self.offset_conv2[lv], cat([offset, upOffset])))
                offset = lrelu(conv(self.offset_conv3[lv], offset))
            feat = self.dcn_pack[lv](nbr[i - 1], offset)
            if i < 3:
                feat = conv(self.feat_conv[lv], cat([feat, upFeat]))
            if i > 1:
                feat = lrelu(feat)
                h, w = offset.shape[1], offset.shape[2]
                upOffset = resizeBilinear(offset, 2 * h, 2 * w) * 2.0
                upFeat = resizeBilinear(feat, 2 * h, 2 * w)
        offset = lrelu(conv(self.cas_offset_conv1, cat([feat, ref[0]])))
        offset = lrelu(conv(self.cas_offset_conv2, offset))
        return lrelu(self.cas_dcnpack(feat, offset))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, H, W, 3), H and W multiples of 4 -> (B, H, W, C).  The
        N neighbours of each clip align as one batch of B N, as in JAX."""
        self.calls += 1
        B, N, H, W, C = x.shape
        center = N // 2
        l1 = conv(self.feature_extraction, lrelu(conv(self.conv_first, x.reshape(B * N, H, W, C))))
        l2 = lrelu(conv(self.conv_l2_2, lrelu(conv(self.conv_l2_1, l1))))
        l3 = lrelu(conv(self.conv_l3_2, lrelu(conv(self.conv_l3_1, l2))))
        nbr = [l1, l2, l3]
        ref = []
        for lv in nbr:
            s = lv.shape[1:]
            ref.append(lv.reshape(B, N, *s)[:, center : center + 1].expand(B, N, *s).reshape(B * N, *s))
        aligned = self.pcd_align(nbr, ref).reshape(B, N, H, W, -1)
        return self.fusion(aligned, center)


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

    def backwardScan(self, inp, flow, warps, kfs) -> torch.Tensor:
        """Backward recurrence over one chunk (videoSR.py:415-431), last
        frame first, from a zero state: inp (T, H, W, 3) in the model's
        dtype, flow (T, H, W, 2) fp32, ``warps[t]`` whether frame t has a
        flow, ``kfs[t]`` its keyframe features (H, W, C) or None ->
        (T, H, W, C)."""
        T, H, W, _ = inp.shape
        featProp = inp.new_zeros((1, H, W, NumFeat))
        outs = [None] * T
        for t in reversed(range(T)):
            if warps[t]:
                featProp = propWarp(featProp, flow[t : t + 1])
            if kfs[t] is not None:
                featProp = conv(self.backward_fusion, cat([featProp, kfs[t][None]]))
            featProp = conv(self.backward_trunk, cat([inp[t : t + 1], featProp]))
            outs[t] = featProp[0]
        return torch.stack(outs)

    def forwardScan(self, featProp, inp, bwd, flow, warps, kfs):
        """Forward recurrence (videoSR.py:446-460) from ``featProp``
        (1, H, W, C), with ``bwd[t]`` the backward pass's features of
        frame t -> (outputs (T, H, W, C), the state after the last frame)."""
        outs = []
        for t in range(inp.shape[0]):
            if warps[t]:
                featProp = propWarp(featProp, flow[t : t + 1])
            if kfs[t] is not None:
                featProp = conv(self.forward_fusion, cat([featProp, kfs[t][None]]))
            featProp = conv(self.forward_trunk, cat([inp[t : t + 1], bwd[t][None], featProp]))
            outs.append(featProp[0])
        return torch.stack(outs), featProp

    def upsampleChunk(self, inp: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3), (T, H, W, C) -> (T, 4H, 4W, 3) fp32: the upsampler
        plus the bilinear x4 of the input, ``UpSubBatch`` frames a call."""
        outs = []
        for s in range(0, inp.shape[0], UpSubBatch):
            i, f = inp[s : s + UpSubBatch], feat[s : s + UpSubBatch]
            up = resizeBilinear(i, 4 * i.shape[1], 4 * i.shape[2])
            outs.append(conv(self.upsample, f).float() + up.float())
        return torch.cat(outs)


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
    """A lazy (ref, row) stream item as its row, or None."""
    return None if item is None else item[0][item[1]]


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
        with torch.inference_mode():
            if kfPos:
                clips = torch.stack([f for i in kfPos for f in keyframeClips[i]]).to(opt.dtype)
                clips = clips.reshape((-1, RefTime) + clips.shape[1:])
                kfFeats = torch.cat([model.edvr(clips[j : j + 1]) for j in range(clips.shape[0])])
                for rank, i in enumerate(kfPos):
                    featItems[i] = (kfFeats, rank)
            flows = model.spynet(_stackPairs(flowInp[:n], inp[0], opt.dtype)).float()
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
            flows = model.spynet(_stackPairs(flowInp[:n], inp[0], opt.dtype).flip(1)).float()  # reversed pairs
            x = inp.to(opt.dtype)
            # each backward window's first item is a real frame's (outputs, row)
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
