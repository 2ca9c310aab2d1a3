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

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.stream import InfiniteSource, RowRef, Stream, StreamGraph, stackBatch
from moephoto_tpu_torch.models.api import prelu, resizeBilinear
from moephoto_tpu_torch.models.streamcommon import StreamOpt, alignPad, makeStreamFunc
from moephoto_tpu_torch.ops.warp import warp
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


def warpExact(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """IFRNet's Warp (IFRNet.py:19-35): its kw/kh normalisation and
    align_corners=True cancel, so it samples at exactly x + u, border
    padding."""
    return warp(img, flow, "border")


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

    def encodeFull(self, frames: torch.Tensor):
        """frames (r, H, W, 3) fp32 -> (means (r, 1, 1, 1) fp32, normalised
        frames fp32, the 4 feature levels in the model's dtype)."""
        dtype = self.encoder.pyramids[0][0][0].weight.dtype
        m = frames.float().mean(dim=(1, 2, 3), keepdim=True)
        inpN = frames - m.to(frames.dtype)
        return m, inpN, self.encoder(inpN.to(dtype))

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

    def decodePost(self, feats, embt, pairN, means, ensemble: int = 0) -> torch.Tensor:
        """Decoder and merge for r pairs with k times each -> (r, k, H, W, 3),
        one pair after another, as the JAX package's chunk program unrolls
        them: each warp runs at one pair's shapes.  (:meth:`decode` and
        :meth:`postOut` also take the r pairs as one batch.)"""
        dtype = feats[0].dtype
        preds = []
        for i in range(embt.shape[0]):
            t = embt[i : i + 1]
            dec = self.decode([f[i : i + 1] for f in feats], t.to(dtype), ensemble)
            preds.append(self.postOut(pairN[i : i + 1], means[i : i + 1], t, dec))
        return torch.stack(preds)


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
    """Level-0 feature map of a (pyramid, i) reference item."""
    pyr, i = item
    return pyr[0][i]


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
        out = []
        for l in range(4):
            cols = [stackBatch([RowRef(w[s][0][l], w[s][1]) for w in wins]) for s in (0, 1)]
            out.append(torch.stack(cols, dim=1))
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
                    feats = [torch.stack([pyrL[l][iL], pyrR[l][iR]])[None] for l in range(4)]
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
