"""Step-JSON pipeline compiler.

A JSON list of ``{'op': ...}`` dicts compiles to a composed function plus
a progress-Node list, as in the JAX package.  Ported ops: ``file``,
``buffer``, ``SR``, ``resize``, ``DN``, ``dehaze``, ``slomo``, ``VSR`` and
``output``; ``demob`` raises ``NotImplementedError`` (ESTRNN, ROADMAP A11),
as do the models the registry has not ported (A7).

In-pipeline image representation: torch float32 HWC in [0, 1] on the
compute device between steps; the ``output`` step copies to the host.
"""

from __future__ import annotations

import logging
from functools import reduce
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.executor import ModelExec, rgbFilter
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.progress import Node
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.utils import imageio

NOT_PORTED = {"demob": "ROADMAP A11"}  # op -> the item it waits for
videoOps = {"slomo", "VSR", "demob"}
apply_ = lambda v, f: f(v)
identity = lambda x, *_, **__: x
NonNullWrap = lambda f: lambda x: f(x) if x is not None else None
applyNonNull = lambda v, f: NonNullWrap(f)(v)
newNode = lambda opt, op, load=1, total=1: Node(op, load, total, name=opt.get("name", None))


def convertValues(T, o, keys):
    for key in keys:
        if key in o:
            o[key] = T(o[key])


def appendFuncs(f, node, funcs, wrap=True):
    g = node.bindFunc(f)
    funcs.append(NonNullWrap(g) if wrap else g)
    return node


BGR2RGB = lambda im: im.flip(-1)


def toDevice(im) -> torch.Tensor:
    """Host HWC uint/float -> float32 HWC in [0, 1] on the compute device
    (a tensor, as ``buffer`` frames arrive, only moves there)."""
    if isinstance(im, torch.Tensor):
        return im.to(config.torchDevice(), torch.float32)
    arr = np.asarray(im)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65536.0
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(config.torchDevice())


def execFilter(exec_: ModelExec) -> Callable:
    """The step function of a model: tiled, or whole for a ``noTile``
    model, with the alpha channel passed around the model either way (the
    JAX package hands a whole-image model all four channels, and AiLUT's
    backbone then refuses an RGBA image)."""
    return rgbFilter(exec_.applyWhole if getattr(exec_, "noTile", False) else exec_)


# --------------------------------------------------------------------------
# step builders: (opt, outType, nodes) -> (funcs, nodes, outType)
# --------------------------------------------------------------------------


def procInput(source, bitDepth, fs, out):
    out["load"], out["sf"] = 1, 1
    node = Node({"op": "toTorch", "bits": bitDepth})
    fs.append(NonNullWrap(node.bindFunc(toDevice)))
    return fs, [node], out


def procDN(opt, out, *_):
    exec_ = opt["opt"]
    node = newNode(opt, dict(op="DN", model=opt["model"]), out["load"])
    return [NonNullWrap(node.bindFunc(execFilter(exec_)))], [node], out


def convertChannel(out):
    out["channel"] = 0
    fs = []
    return fs, [appendFuncs(BGR2RGB, Node(dict(op="Channel")), fs)]


def procSR(opt, out, *_):
    load = out["load"]
    scale = opt["scale"]
    mode = opt["model"]
    exec_ = opt["opt"]
    if exec_ is None:
        raise KeyError(f"SR model {mode!r} x{scale} is not in the registry")
    es = exec_.ensemble + 1
    if not scale > 1:
        raise TypeError("Invalid scale setting for SR.")
    out["load"] = load * scale * scale
    fs, ns = convertChannel(out) if out["channel"] and mode == "gan" else ([], [])
    ns.append(appendFuncs(execFilter(exec_), newNode(opt, dict(op="SR", model=mode, scale=scale), load * es), fs))
    return fs, ns, out


def procDehaze(opt, out, *_):
    load = out["load"]
    exec_ = opt["opt"]
    model = opt.get("model", "dehaze")
    fs, ns = convertChannel(out) if out["channel"] else ([], [])
    node = newNode(opt, dict(op=model), load)
    ns.append(appendFuncs(execFilter(exec_), node, fs))
    return fs, ns, out


def resizeStep(opt, out, pos=0, nodes=()):
    """Bilinear, nearest or bicubic resize of an HWC image to
    ``width``/``height`` or by ``scaleW``/``scaleH``, as the JAX package's
    ``resizeStep``.  The first image sets this step's node load and scales
    the later nodes' loads by the area ratio; a video ``source`` does so
    once and keeps the size for every frame."""
    from moephoto_tpu_torch.models.api import resizeBilinear, resizeCubic, resizeNearest

    opt_ = dict(opt)
    opt_.setdefault("method", "bilinear")
    state = {"update": True, "h": 1, "w": 1}

    def f(im):
        if state["update"]:
            h, w = im.shape[0], im.shape[1]
            nh = round(h * opt_["scaleH"]) if "scaleH" in opt_ else opt_["height"]
            nw = round(w * opt_["scaleW"]) if "scaleW" in opt_ else opt_["width"]
            state["h"], state["w"] = nh, nw
            if len(nodes):
                nodes[pos].load = im.numel()
                for n in nodes[pos + 1 :]:
                    n.multipleLoad(nh * nw / (h * w))
            if out["source"]:
                state["update"] = False
        nh, nw = state["h"], state["w"]
        x = im[None]
        if opt_["method"] == "nearest":
            y = resizeNearest(x, nh, nw)
        elif opt_["method"] == "bicubic":
            y = resizeCubic(x, nh, nw)
        else:
            y = resizeBilinear(x, nh, nw)
        return y[0]

    return f


def procResize(opt, out, nodes):
    node = newNode(opt, dict(op="resize", mode=opt.get("method", "bilinear")), out["load"])
    return [node.bindFunc(NonNullWrap(resizeStep(opt, out, len(nodes), nodes)))], [node], out


def toFloatHost(im) -> np.ndarray:
    """Device image -> host float32 numpy (waits for the device)."""
    return im.float().cpu().numpy()


def restrictSize(maxSide: int):
    """Downscale an HWC tensor to fit within ``maxSide`` (preview helper,
    reference ``restrictSize`` imageProcess.py:197-214)."""
    from moephoto_tpu_torch.models.api import resizeBilinear

    def f(im):
        h, w = im.shape[0], im.shape[1]
        if h <= maxSide and w <= maxSide:
            return im
        s = min(maxSide / h, maxSide / w)
        return resizeBilinear(im[None], round(h * s), round(w * s))[0]

    return f


def _writePreview(im):
    """Write a preview of the current frame into the shared-memory
    exchange and notify the client (reference ``fPreview``
    procedure.py:36-44): at most 2048 px, 8-bit, RGB.  Best effort: a
    failed preview does not stop the video."""
    if config.videoPreview and context.shared is not None and context.root is not None:
        try:
            arr = imageio.toOutput(toFloatHost(restrictSize(2048)(im)), 8)
            context.shared.seek(0)
            imageio.writeFile(arr, context.shared, context, config.videoPreview)
            context.root.trace(0, preview="{}/.preview.{}".format(config.outDir, config.videoPreview),
                               fileSize=context.shared.tell())
        except Exception:  # the video goes on without its preview
            logging.getLogger("Moe").exception("video preview failed")
    return im


def procOutput(opt, out, *_):
    load = out["load"]
    bitDepthOut = out["bitDepth"]
    node0 = Node(dict(op="toFloat"), load)
    node1 = newNode(opt, dict(op="toOutput", bits=bitDepthOut), load)
    fOutput = node1.bindFunc(lambda im: imageio.toOutput(im, bitDepthOut))
    fs = [NonNullWrap(node0.bindFunc(toFloatHost)), NonNullWrap(fOutput)]
    ns = [node0, node1]
    if out["source"]:  # video: raw BGR buffers for the encode pipe
        incomingBGR = bool(out["channel"])
        fTrace = lambda x: context.root.trace(1 / out["sf"]) or x
        fs1 = [node0.bindFunc(toFloatHost), fOutput]
        if not out["channel"]:
            ns.append(appendFuncs(lambda im: im[..., ::-1], Node(dict(op="Channel")), fs1, False))
            out["channel"] = 1
        ns.append(appendFuncs(lambda im: imageio.toBuffer(im, bitDepthOut),
                              Node(dict(op="toBuffer", bits=bitDepthOut), load), fs1, False))
        state = {"i": 0}

        def o(im):
            res = reduce(applyNonNull, fs1, im)
            if im is not None and state["i"] % 30 == 0:
                # the preview wants RGB; the frame is BGR unless a model
                # converted it upstream
                _writePreview(im.flip(-1) if incomingBGR else im)
            state["i"] += 1
            return [res]

        fs = [o, fTrace]
    return fs, ns, out


def procVideo(op):
    """Temporal step builders, resolved lazily so image-only runs never
    import the temporal models.  Ported: ``slomo``, ``VSR``."""

    def f(opt, out, *_):
        load = out["load"]
        fs, ns = convertChannel(out) if out["channel"] else ([], [])
        if op == "VSR":
            out["load"] = load * 16
            ns.append(newNode(opt, dict(op="VSR", learn=0), load))
            from moephoto_tpu_torch.models.iconvsr import doVSR

            return fs + [doVSR], ns, out
        if op == "slomo":
            out["sf"] *= opt["sf"]
            node = newNode(opt, dict(op="slomo"), load, opt["sf"])
            from moephoto_tpu_torch.models.ifrnet import doSlomo

            return fs + [doSlomo], ns + [node], out
        raise NotImplementedError(f"step op {op!r} is not ported yet")

    return f


def _getOptVideo(op):
    def f(opt):
        if op == "slomo":
            from moephoto_tpu_torch.models import ifrnet

            return ifrnet.getOpt(opt)
        if op == "VSR":
            from moephoto_tpu_torch.models import iconvsr

            return iconvsr.getOpt(opt)
        raise NotImplementedError(f"step op {op!r} is not ported yet")

    return f


procs: Dict[str, Callable] = dict(
    file=(
        lambda _, _0, nodes: procInput(
            "file",
            8,
            [context.getFile, lambda f: imageio.readFile(f, context)],
            dict(bitDepth=8, channel=0, source=0),
        )
    ),
    buffer=(
        lambda opt, *_: procInput(
            "buffer",
            opt["bitDepth"],
            [lambda args: imageio.fromBuffer(*args, bitDepth=opt["bitDepth"], device=config.torchDevice())],
            dict(bitDepth=opt["bitDepth"], channel=1, source=1),
        )
    ),
    DN=procDN,
    SR=procSR,
    dehaze=procDehaze,
    resize=procResize,
    output=procOutput,
    slomo=procVideo("slomo"),
    VSR=procVideo("VSR"),
)

stepOpts = dict(
    SR={"toInt": ["scale", "ensemble"], "getOpt": registry.getSR},
    resize={"toInt": ["width", "height"], "toFloat": ["scaleW", "scaleH"]},
    DN={"toFloat": ["strength"], "getOpt": registry.getDN},
    dehaze={"toFloat": ["strength"], "getOpt": registry.getDehaze},
    slomo={
        "toInt": ["ensemble"],
        "toFloat": ["sf", "high", "low"],
        "isEnabled": ["dedupe"],
        "getOpt": _getOptVideo("slomo"),
    },
    VSR={"getOpt": _getOptVideo("VSR")},
)


def genProcess(steps: List[dict], root: bool = True, outType: Optional[dict] = None):
    """Compile a step list into (process, nodes)."""
    for opt in steps:
        if opt["op"] in NOT_PORTED:
            raise NotImplementedError(f"step op {opt['op']!r} is not ported yet ({NOT_PORTED[opt['op']]})")
    funcs: List[Callable] = []
    nodes: List[Node] = []
    last = identity
    rf = lambda im: reduce(apply_, funcs, im)
    if root:
        stepOffset = 0 if steps[0]["op"] == "file" else 2
        for i, opt in enumerate(steps):
            opt["name"] = i + stepOffset
            if opt["op"] in stepOpts:
                so = stepOpts[opt["op"]]
                convertValues(int, opt, so.get("toInt", []))
                convertValues(float, opt, so.get("toFloat", []))
                convertValues(
                    lambda obj: obj.get("enable", 0) if isinstance(obj, dict) else obj,
                    opt,
                    so.get("isEnabled", []),
                )
                if "getOpt" in so:
                    opt["opt"] = so["getOpt"](opt)
        if steps[-1]["op"] != "output":
            steps.append(dict(op="output"))
        process = lambda im, name=None: last(rf(im), name, context)
    else:
        process = rf
    for i, opt in enumerate(steps):
        op = opt["op"]
        fs, ns, outType = procs[op](opt, outType, nodes)
        funcs.extend(fs)
        nodes.extend(ns)
        if op in videoOps:
            # the steps after a temporal one run per output frame, inside it
            if i + 1 < len(steps):
                f, nodesAfter = genProcess(steps[i + 1 :], False, outType)
            else:
                f, nodesAfter = identity, []
            funcs[-1] = funcs[-1](f, nodes[-1], opt["opt"])
            nodeAfter = Node({}, total=opt.get("sf", 1), learn=0)
            for node in nodesAfter:
                nodeAfter.append(node)
            nodes.append(nodeAfter)
            break
    if root and steps[0]["op"] == "file":
        n = Node({"op": "write"}, outType["load"])
        nodes.append(n)
        last = n.bindFunc(imageio.writeFile)
    else:
        context.imageMode = "RGB"
    return process, nodes
