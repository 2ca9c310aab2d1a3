"""Step-JSON pipeline compiler.

A JSON list of ``{'op': ...}`` dicts compiles to a composed function plus
a progress-Node list, as in the JAX package.  Ported ops: ``file``,
``SR`` and ``output`` (image branch); the others raise
``NotImplementedError``.

In-pipeline image representation: torch float32 HWC in [0, 1] on the
compute device between steps; the ``output`` step copies to the host.
"""

from __future__ import annotations

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

NOT_PORTED = {"buffer", "DN", "dehaze", "resize", "slomo", "VSR", "demob"}
apply_ = lambda v, f: f(v)
identity = lambda x, *_, **__: x
NonNullWrap = lambda f: lambda x: f(x) if x is not None else None
newNode = lambda opt, op, load=1, total=1: Node(op, load, total, name=opt.get("name", None))


def convertValues(T, o, keys):
    for key in keys:
        if key in o:
            o[key] = T(o[key])


def appendFuncs(f, node, funcs, wrap=True):
    g = node.bindFunc(f)
    funcs.append(NonNullWrap(g) if wrap else g)
    return node


def toDevice(im) -> torch.Tensor:
    """Host HWC uint/float -> float32 HWC in [0, 1] on the compute device."""
    arr = np.asarray(im)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65536.0
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(config.torchDevice())


def execFilter(exec_: ModelExec) -> Callable:
    if getattr(exec_, "noTile", False):
        return exec_.applyWhole
    return rgbFilter(exec_)


# --------------------------------------------------------------------------
# step builders: (opt, outType, nodes) -> (funcs, nodes, outType)
# --------------------------------------------------------------------------


def procInput(source, bitDepth, fs, out):
    out["load"], out["sf"] = 1, 1
    node = Node({"op": "toTorch", "bits": bitDepth})
    fs.append(NonNullWrap(node.bindFunc(toDevice)))
    return fs, [node], out


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
    fs = []
    node = appendFuncs(
        execFilter(exec_), newNode(opt, dict(op="SR", model=mode, scale=scale), load * es), fs
    )
    return fs, [node], out


def toFloatHost(im) -> np.ndarray:
    """Device image -> host float32 numpy (waits for the device)."""
    return im.float().cpu().numpy()


def procOutput(opt, out, *_):
    if out["source"]:
        raise NotImplementedError("video output is not ported yet")
    load = out["load"]
    bitDepthOut = out["bitDepth"]
    node0 = Node(dict(op="toFloat"), load)
    node1 = newNode(opt, dict(op="toOutput", bits=bitDepthOut), load)
    fOutput = node1.bindFunc(lambda im: imageio.toOutput(im, bitDepthOut))
    fs = [NonNullWrap(node0.bindFunc(toFloatHost)), NonNullWrap(fOutput)]
    return fs, [node0, node1], out


procs: Dict[str, Callable] = dict(
    file=(
        lambda _, _0, nodes: procInput(
            "file",
            8,
            [context.getFile, lambda f: imageio.readFile(f, context)],
            dict(bitDepth=8, channel=0, source=0),
        )
    ),
    SR=procSR,
    output=procOutput,
)

stepOpts = dict(SR={"toInt": ["scale", "ensemble"], "getOpt": registry.getSR})


def genProcess(steps: List[dict], root: bool = True, outType: Optional[dict] = None):
    """Compile a step list into (process, nodes)."""
    for opt in steps:
        if opt["op"] in NOT_PORTED:
            raise NotImplementedError(f"step op {opt['op']!r} is not ported yet")
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
                if "getOpt" in so:
                    opt["opt"] = so["getOpt"](opt)
        if steps[-1]["op"] != "output":
            steps.append(dict(op="output"))
        process = lambda im, name=None: last(rf(im), name, context)
    else:
        process = rf
    for opt in steps:
        fs, ns, outType = procs[opt["op"]](opt, outType, nodes)
        funcs.extend(fs)
        nodes.extend(ns)
    if root and steps[0]["op"] == "file":
        n = Node({"op": "write"}, outType["load"])
        nodes.append(n)
        last = n.bindFunc(imageio.writeFile)
    else:
        context.imageMode = "RGB"
    return process, nodes
