"""ESTRNN recurrent video deblur (reference ``python/ESTRNN.py``; Zhong et
al., ECCV 2020; JAX ``moephoto_tpu/models/estrnn.py``).

Dataflow: a per-frame RDBCell with a carried hidden state gives features
at 1/4 of the frame's size and, pooled, one weight vector a frame; a
window of 5 frames' features and weights goes through the GSA global
spatio-temporal attention and the transposed-conv reconstructor.  The
stream (:func:`doESTRNN`) is the JAX package's 2-stage graph: the
recurrence runs on chunks of ``Chunk`` frames as a Python loop, with the
hidden state carried across chunks; the fusion stage takes up to
``Chunk`` windows at once.

Tensors are NHWC at every function boundary; convolutions run on NCHW
views of them (channels-last in memory on the card).  The convolutions
stay cuDNN's and the two small products ``nn.Linear``: the JAX module has
no Pallas kernel.

Under ``config.meshShape`` both stages run row-sharded
(``parallel/temporal.py`` :func:`rowStage`), as the JAX package's
``cellScanPoolJit`` and ``gsaReconsJit``: the frames' rows split at
multiples of 4 (two stride-2 convs), each conv segment takes a halo of
its stated row reach (``parallel/sharded.py`` :func:`rowSegment`), the
hidden state stays row shards across chunks, and the pooled weights sum
every shard's rows.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import torch
from torch import nn

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.stream import Stream, StreamGraph
from moephoto_tpu_torch.models.api import conv, convTranspose2d, gelu, linear
from moephoto_tpu_torch.models.streamcommon import StreamOpt, alignPad, makeStreamFunc
from moephoto_tpu_torch.parallel.mesh import replicaOn
from moephoto_tpu_torch.parallel.sharded import RowShards, padRows, reflectIndex, rowSegment, scaleBounds, zipShards
from moephoto_tpu_torch.parallel.temporal import rowStage
from moephoto_tpu_torch.progress import Node

NumFeat = 16
RefTime = 5  # past 2 + current + future 2 (ESTRNN.py:21-27)
pastFrames = 2
futureFrames = 2
DS_ratio = 2
nBlocks = 15
Chunk = 8  # frames a recurrence call, windows a fusion call
ReconsAlign = 32  # the fusion map is reflect-padded to this many rows and columns (ESTRNN.py:223)

modelPaths = {
    "1ms8ms": "model/ESTRNN/ESTRNN_C80B15_BSD_1ms8ms.pth",
    "2ms16ms": "model/ESTRNN/ESTRNN_C80B15_BSD_2ms16ms.pth",
    "3ms24ms": "model/ESTRNN/ESTRNN_C80B15_BSD_3ms24ms.pth",
}

cat = lambda xs: torch.cat(xs, -1)

# Row-sharded stages.  The frames split at multiples of ALIGN rows, so both
# stride-2 convs cut whole rows.  Each segment's halo is its row reach in
# its input's rows:
#   the encoder (F_B0 5x5: 2; an RDB of three 3x3 convs: 3; the 5x5 stride-2
#   conv: 2; at 1/2 an RDB, 3 rows = 6, and the stride-2 conv, 2 rows = 4):
#   17 frame rows, rounded up to a multiple of 4 so the crop is whole rows;
#   the RDNet (15 RDBs of three 3x3 convs, then a 1x1 and a 3x3): 46 rows at
#   1/4; the hidden path F_h (3x3, RDB, 3x3): 5 rows at 1/4;
#   the reconstructor (two ConvTranspose 3/2/1, one input row each, and a
#   5x5 conv at full size, half a row at 1/4): 1 + 1/2 + 1/2 rows at 1/4.
# GSA is pointwise in space and takes no halo.  A shard shorter than a
# segment's halo runs it gathered (at 720p on 4 shards the RDNet's 45 rows).
# The encoder runs gathered (GATHER_ENCODER; the tests switch it off to hold
# its halo): cuDNN picks its algorithm by shape, and in bf16 at 720p the
# encoder's 200- and 220-row windows on 4 shards rounded 0.038 % of its
# outputs one ulp apart from the whole frame's (the 380-row windows on 2
# shards rounded none), which the recurrence then carries into every later
# frame (PERF.md; ``sharded.checkingSegments`` finds such segments).
ALIGN = 1 << DS_ratio
GATHER_ENCODER = True
ENC_HALO = 20
RDNET_HALO = nBlocks * 3 + 1
HIDDEN_HALO = 5
RECONS_HALO = 2


class DenseLayer(nn.Module):
    """One dense layer of an RDB: a 3x3 conv growing by ``g`` channels
    (key ``conv``), GELU after it."""

    def __init__(self, cin: int, g: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, g, 3, 1, 1)


class RDB(nn.ModuleList):
    """Residual dense block (ESTRNN.py:60-74): ``numLayer`` dense GELU
    layers, each input the concatenation of all before, then a 1x1 conv
    back to ``c0`` channels, plus the input.  Keys ``{i}.conv`` and
    ``{numLayer}``."""

    def __init__(self, c0: int, g: int, numLayer: int = 3):
        super().__init__([DenseLayer(c0 + i * g, g) for i in range(numLayer)] + [nn.Conv2d(c0 + numLayer * g, c0, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in list(self)[:-1]:
            h = cat([h, gelu(conv(layer.conv, h))])
        return x + conv(self[-1], h)


class RDBDS(nn.ModuleList):
    """RDB, then a stride-2 5x5 conv doubling the channels (ESTRNN.py:94-97);
    keys ``0``, ``1``."""

    def __init__(self, c: int, g: int):
        super().__init__([RDB(c, g), nn.Conv2d(c, 2 * c, 5, 2, 2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self[1], self[0](x))


class RDNet(nn.Module):
    """RDNet (ESTRNN.py:77-91): 15 RDBs, all their outputs concatenated, a
    1x1 and a 3x3 conv."""

    def __init__(self, c: int = 80, g: int = 32):
        super().__init__()
        self.RDBs = nn.ModuleList(RDB(c, g) for _ in range(nBlocks))
        self.conv1x1 = nn.Conv2d(nBlocks * c, c, 1)
        self.conv3x3 = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for rdb in self.RDBs:
            x = rdb(x)
            outs.append(x)
        return conv(self.conv3x3, conv(self.conv1x1, cat(outs)))


class HiddenPath(nn.ModuleList):
    """The new hidden state from the cell's concatenation: 3x3 conv, RDB,
    3x3 conv (keys ``0``, ``1``, ``2``)."""

    def __init__(self, cin: int = 80):
        super().__init__([nn.Conv2d(cin, NumFeat, 3, 1, 1), RDB(NumFeat, NumFeat),
                          nn.Conv2d(NumFeat, NumFeat, 3, 1, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self[2], self[1](conv(self[0], x)))


class RDBCell(nn.Module):
    """RDBCell (ESTRNN.py:140-164), split at the hidden state's entry: the
    encoder of the frame, then the RDNet and the hidden path on the frame's
    features concatenated with the hidden state."""

    def __init__(self):
        super().__init__()
        self.F_B0 = nn.Conv2d(3, NumFeat, 5, 1, 2)
        self.F_B1 = RDBDS(NumFeat, NumFeat)
        self.F_B2 = RDBDS(2 * NumFeat, 24)
        self.F_R = RDNet(5 * NumFeat, 32)
        self.F_h = HiddenPath(5 * NumFeat)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H / 4, W / 4, 64)."""
        return self.F_B2(self.F_B1(conv(self.F_B0, x)))

    def forward(self, x: torch.Tensor, hidden: torch.Tensor):
        """(features (B, H / 4, W / 4, 80), new hidden (B, H / 4, W / 4, 16))."""
        out = cat([self.encode(x), hidden])
        return self.F_R(out), self.F_h(out)


class GSA(nn.Module):
    """GSA fusion (ESTRNN.py:100-137): each neighbour's features beside the
    centre frame's, gated by a sigmoid of its pooled weights, condensed and
    fused.  Pointwise in space."""

    def __init__(self, c: int = 80):
        super().__init__()
        self.F_f = nn.Sequential(linear(2 * c, 4 * c), nn.GELU(), linear(4 * c, 2 * c))
        self.F_p = nn.Sequential(nn.Conv2d(2 * c, 4 * c, 1), nn.Conv2d(4 * c, 2 * c, 1))
        self.condense = nn.Conv2d(2 * c, c, 1)
        self.fusion = nn.Conv2d(RefTime * c, RefTime * c, 1)

    def forward(self, hs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """hs (b, 5, h, w, c), weight (b, 5, c) -> (b, h, w, 5 c)."""
        b, n, h, w, c = hs.shape
        ids = [i for i in range(n) if i != pastFrames]
        ref, wRef = hs[:, pastFrames], weight[:, pastFrames]
        cor = torch.stack([cat([ref, hs[:, i]]) for i in ids], 1).reshape(b * 4, h, w, 2 * c)
        wCat = torch.stack([cat([wRef, weight[:, i]]) for i in ids], 1)  # (b, 4, 2c)
        wf = torch.sigmoid(self.F_f[2](gelu(self.F_f[0](wCat))))
        corF = conv(self.F_p[1], conv(self.F_p[0], cor))
        corF = conv(self.condense, wf.reshape(b * 4, 1, 1, 2 * c) * corF)  # (b 4, h, w, c)
        corL = cat([corF.reshape(b, 4, h, w, c).permute(0, 2, 3, 1, 4).reshape(b, h, w, 4 * c), ref])
        return conv(self.fusion, corL)


class Reconstructor(nn.Sequential):
    """Two stride-2 transposed convs and a 5x5 conv (ESTRNN.py:166-172),
    keys ``0``, ``1``, ``2``; (B, h, w, 400) -> (B, 4 h, 4 w, 3)."""

    def __init__(self, c: int = 400):
        super().__init__(convTranspose2d(c, 2 * NumFeat), convTranspose2d(2 * NumFeat, NumFeat),
                         nn.Conv2d(NumFeat, 3, 5, 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self[2], conv(self[1], conv(self[0], x)))


def isConvT(key: str, shape=None) -> bool:
    """The reconstructor's two ConvTranspose2d weights (JAX ``estrnn.py:151``)."""
    return key in ("recons.0.weight", "recons.1.weight")


def _poolSum(hs: torch.Tensor) -> torch.Tensor:
    # each frame's features summed over (h, w) in fp64: the per-shard sums add up to the
    # whole-frame sum in any order up to fp64 rounding, far below the fp32 rounding after it
    return hs.sum(dim=(1, 2), dtype=torch.float64)


def _padTo(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` reflect-padded on ``axis`` from ``n`` to a multiple of
    ReconsAlign (numpy's ``reflect``, as ``jnp.pad``)."""
    N = -(-n // ReconsAlign) * ReconsAlign
    return x if N == n else x.index_select(axis, reflectIndex(n, N).to(x.device))


class ESTRNN(nn.Module):
    """ESTRNN's modules under the checkpoint's module names."""

    def __init__(self):
        super().__init__()
        self.cell = RDBCell()
        self.fusion = GSA()
        self.recons = Reconstructor()

    def _cellScanPoolPlain(self, frames: torch.Tensor, hidden: torch.Tensor):
        hs = []
        for t in range(frames.shape[0]):
            feat, hidden = self.cell(frames[t : t + 1], hidden)
            hs.append(feat)
        hs = torch.cat(hs)
        w = (_poolSum(hs) / (hs.shape[1] * hs.shape[2])).float().to(hs.dtype)
        return hs, w, hidden

    def _cellScanPoolSharded(self, frames: RowShards, hidden):
        """The recurrence on row shards: the encoder (gathered while
        GATHER_ENCODER), the RDNet and the hidden path segments of their
        stated reach, the hidden state row shards at 1/4 of the frames'
        bounds."""
        quarter = scaleBounds(frames.bounds, Fraction(1, ALIGN))
        if not (isinstance(hidden, RowShards) and list(hidden.bounds) == quarter and hidden.devices == frames.devices):
            whole = hidden.gather() if isinstance(hidden, RowShards) else hidden
            hidden = RowShards.split(whole, frames.devices, 1, bounds=quarter)
        cell = lambda t: replicaOn(self.cell, t.device)  # noqa: E731
        hs = []
        for t in range(frames.shape[0]):
            x = frames.map(lambda p: p[t : t + 1])
            enc = rowSegment(lambda v: cell(v).encode(v), x, ENC_HALO, Fraction(1, ALIGN), GATHER_ENCODER)
            out = zipShards(lambda a, b: cat([a, b]), enc, hidden)
            hs.append(rowSegment(lambda v: cell(v).F_R(v), out, RDNET_HALO))
            hidden = rowSegment(lambda v: cell(v).F_h(v), out, HIDDEN_HALO)
        hs = zipShards(lambda *ps: torch.cat(ps), *hs)
        home = hs.parts[0].device
        total = torch.stack([_poolSum(p).to(home) for p in hs.parts]).sum(0)
        w = (total / (hs.rows * hs.shape[2])).float().to(hs.parts[0].dtype)
        return hs, w, hidden

    # The recurrence over a chunk of frames with the GSA pooling weights (JAX
    # ``cellScanPoolApply``): frames (T, H, W, 3), hidden (1, H / 4, W / 4, 16) in
    # the model's dtype -> (features (T, H / 4, W / 4, 80), weights (T, 80), the
    # hidden state after the last frame).  Under a mesh the frames' rows shard
    # and the features and the hidden state stay row shards.
    cellScanPool = rowStage(_cellScanPoolPlain, _cellScanPoolSharded, (None, 1, None), (1, None, 1), align=ALIGN)

    def _gsaReconsPlain(self, hsB: torch.Tensor, wB: torch.Tensor) -> torch.Tensor:
        x = self.fusion(hsB, wB)
        h, w = x.shape[1], x.shape[2]
        return self.recons(_padTo(_padTo(x, 1, h), 2, w))[:, : 4 * h, : 4 * w].float()

    def _gsaReconsSharded(self, hsB: RowShards, wB: torch.Tensor) -> torch.Tensor:
        """GSA shard by shard, the reflect pad's rows on the last shard, the
        reconstructor a segment of RECONS_HALO rows; gathered and cropped."""
        h, w = hsB.rows, hsB.shape[3]
        x = RowShards([_padTo(replicaOn(self.fusion, p.device)(p, wB.to(p.device)), 2, w) for p in hsB.parts],
                      hsB.bounds, 1)
        x = padRows(x, -(-h // ReconsAlign) * ReconsAlign)
        y = rowSegment(lambda v: replicaOn(self.recons, v.device)(v), x, RECONS_HALO, 4).gather()
        return y[:, : 4 * h, : 4 * w].float()

    # GSA fusion and the reconstructor (JAX ``gsaReconsApply``): hsB (r, 5, h, w,
    # 80), wB (r, 5, 80) -> r frames (r, 4 h, 4 w, 3) fp32, from the fusion map
    # reflect-padded to multiples of 32 and cropped back (ESTRNN.py:223).  Under a
    # mesh hsB's rows shard (axis 2) and the frames are gathered.
    gsaRecons = rowStage(_gsaReconsPlain, _gsaReconsSharded, (None, 2, None), None)


class ESTRNNOpt(StreamOpt):
    pass


def getOpt(option: dict, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None) -> ESTRNNOpt:
    """The demob step's option: ESTRNN loaded from the checkpoint of
    ``option["model"]`` (``modelPaths``), a dict of per-module state dicts
    ``{"cell", "fusion", "recons"}``, on the compute device in
    ``config.dtype()`` unless ``dtype`` says.  A key the model needs and
    does not find raises."""
    from moephoto_tpu_torch.pipeline.registry import modelPath

    opt = ESTRNNOpt()
    device = torch.device(device) if device is not None else config.torchDevice()
    opt.dtype = dtype if dtype is not None else config.dtype()
    raw = torch.load(modelPath(modelPaths[option["model"]]), map_location="cpu", weights_only=True)
    model = ESTRNN()
    sd = {f"{mod}.{k}": v for mod in ("cell", "fusion", "recons") for k, v in raw[mod].items()}
    missing = model.load_state_dict(sd, strict=False).missing_keys
    if missing:
        raise KeyError(f"ESTRNN checkpoint lacks {missing[:4]}{' ...' if len(missing) > 4 else ''}")
    model = model.to(device=device, dtype=opt.dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    opt.model = model
    return opt


def _stackWindows(windows) -> object:
    """(r, 5, h, w, c) from r windows of 5 lazy (ref, row) items, a tensor or,
    when the features are row shards, row shards on axis 2."""
    ref = windows[0][0][0]
    if isinstance(ref, RowShards):
        parts = [torch.stack([torch.stack([it[0].parts[j][it[1]] for it in win]) for win in windows])
                 for j in range(ref.n)]
        return RowShards(parts, ref.bounds, 2)
    return torch.stack([torch.stack([it[0][it[1]] for it in win]) for win in windows])


def doESTRNN(func, node, opt: ESTRNNOpt):
    """Assemble the stream graph (reference ``doESTRNN`` :209-224, as the
    JAX package's)."""
    nodes = [Node({"ESTRNN": key}) for key in ("forward", "fusion")]
    graph = StreamGraph()
    sinkList: List = []
    model = opt.model
    hiddenBox = {"h": None}
    w = Stream(RefTime, reserve=1, name="w")

    def calcForward(x, last=None):
        # a chunk of up to Chunk frames through the recurrence, the hidden state
        # carried across chunks; the pooled weights go straight to ``w``
        frames = x.to(opt.dtype)
        T, H, W = frames.shape[:3]
        with torch.inference_mode():
            if hiddenBox["h"] is None:
                hiddenBox["h"] = frames.new_zeros((1, H >> DS_ratio, W >> DS_ratio, NumFeat))
            hs, wArr, hiddenBox["h"] = model.cellScanPool(frames, hiddenBox["h"])
        w.put(wArr)
        return [(hs, i) for i in range(T)]

    def fusionStage(hsWins, wB, last=None):
        with torch.inference_mode():
            out = model.gsaRecons(_stackWindows(hsWins), wB)
        return [out[i] for i in range(out.shape[0])]

    listB = lambda x: x  # noqa: E731
    inp = Stream(name="inp")
    hs = Stream(RefTime, reserve=1, tensor=False, batchFunc=listB, name="hs")
    outS = Stream(store=False, name="out")
    outS.sink = sinkList

    graph.stage(nodes[0].bindFunc(calcForward), [inp], [hs], size=Chunk)
    graph.stage(nodes[1].bindFunc(fusionStage), [hs, w], [outS], size=Chunk)

    def initFunc(o, x):
        o.padF, o.unpadF, size = alignPad(x, 8)
        o.pad = lambda f: o.padF(f)
        h, w_ = x.shape[0], x.shape[1]
        o.unpad = lambda f: f[:h, :w_]
        return size

    return makeStreamFunc(func, node, opt, nodes, "ESTRNN", [hs, w], initFunc, lambda x: inp.put([x]), graph,
                          sinkList)
