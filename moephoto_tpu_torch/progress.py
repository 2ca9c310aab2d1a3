"""Hierarchical progress tracking with an online per-op time model.

Every pipeline stage is a node in a tree; finishing work on a node
updates an exponentially averaged seconds-per-load estimate for that op
kind, and estimates bubble up the tree as ETAs.

On the GPU a step returns as soon as its kernels are queued, so
:meth:`Node.bindFunc` waits for a device result before it traces: each
node then learns the time of its own work, instead of the first step
that copies to the host learning the time of all steps before it.

:meth:`Node.bindFunc` also opens the step's span.  Spans and counters
are ranges of the torch profiler, recorded only while one runs (a
``torch.profiler.profile`` around the work), on the profiler's own
timeline beside the device's kernels; otherwise each costs one check of
the profiler's flag.  Their names:

- ``moe.step.<op>``: one bound step, its ``settle`` included; ``<op>``
  is the node's ``"op"`` (``moe.step.SR``, ``moe.step.toOutput``, the
  request's root ``moe.step.image``), else its op dict's first item as
  ``key.value`` (``moe.step.IFRNet.encode``); ``moe.step.output`` holds
  the video route's output steps of one frame (``pipeline/steps.procOutput``);
- ``moe.sync``: the device synchronisation in :func:`settle`;
- ``moe.engine.chunk``: one chunk of tiles in ``engine/tiling.tiledApply``;
- ``moe.stream.run``: one scheduling pass of ``engine/stream.StreamGraph``;
- ``moe.vsr.edvr``, ``.spynet``, ``.scan``, ``.up``: IconVSR's parts
  (``models/iconvsr.py``);
- ``moe.nafnet.encoder``, ``.middle``, ``.decoder``: NAFNet's three
  stages, once each a model call (``models/nafnet.py``);
- ``moe.count.<name>=<n>``: a zero-length range that records the count
  ``n`` (``tiles_needed`` and ``tiles_run``, once a chunk of tiles;
  ``vsr_keyframes`` and ``vsr_frames``, once a backward chunk of VSR;
  ``in_bytes`` and ``out_bytes``, once an image or frame: the bytes the
  input and output steps copy, ``pipeline/steps.py``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from os.path import exists
from typing import Callable, Dict, List, Optional

import torch
import torch.profiler

EMA_KEEP = 0.9  # weight retained per new sample
SILENT_OPS = {"toFloat", "toOutput", "Channel", "toBuffer", "toTorch"}


class OpStats:
    """Learned seconds-per-unit-load for one op kind."""

    __slots__ = ("op", "weight", "samples")

    def __init__(self, define: dict, learn):
        self.op = define
        self.reset(learn)

    def reset(self, learn=True):
        self.weight = 1e-6 if learn else 1
        self.samples = 0

    def addSample(self, secondsPerLoad: float):
        global _dirty
        if self.samples == 0:
            _dirty = True
        self.samples += 1
        if self.samples <= 2:
            self.weight = secondsPerLoad
        else:
            self.weight = EMA_KEEP * self.weight + (1 - EMA_KEEP) * secondsPerLoad

    def serialize(self) -> dict:
        return dict(op=self.op, weight=self.weight, samples=self.samples)


_registry: Dict[int, OpStats] = {}
_preloaded: Dict[int, tuple] = {}
_dirty = False

opKey = lambda define: hash(frozenset(define.items()))
NullFunc = lambda *args: None


def _statsFor(define: dict, learn) -> OpStats:
    key = opKey(define)
    st = _registry.get(key)
    if st is None:
        st = OpStats(define, learn)
        if key in _preloaded:
            st.weight, st.samples = _preloaded[key]
        _registry[key] = st
    return st


# --- persistence ------------------------------------------------------------

def serializeOps() -> List[dict]:
    return [st.serialize() for st in _registry.values()]


def _writeOps(path: str):
    with open(path, "w") as fp:
        json.dump(serializeOps(), fp, ensure_ascii=False, indent=2)


def saveOps(path: Optional[str] = None, force: bool = False):
    """Write the learned weights to ``path`` on a daemon thread when a
    weight changed since the last write (or ``force``)."""
    global _dirty
    if path and (_dirty or force):
        threading.Thread(target=_writeOps, args=(path,), daemon=True).start()
        _dirty = False
    return serializeOps()


def _readOps(path: str):
    if not exists(path):
        return
    with open(path, "r") as fp:
        for entry in json.load(fp):
            _preloaded[opKey(entry["op"])] = (entry["weight"], entry["samples"])


def loadOps(path: str):
    t = threading.Thread(target=_readOps, args=(path,), daemon=True)
    t.start()
    return t


def clearOps(node, flag: bool = True):
    """Forget learned weights below ``node`` (the bench ``clear`` option)."""
    if not flag:
        return
    _preloaded.clear()

    def walk(n):
        _registry[n.op].reset(n.learn)
        for c in n.nodes:
            walk(c)

    walk(node)


def _childEttSum(node) -> float:
    return sum(c.ett for c in node.nodes) if node.nodes else 1


def updateNode(node):
    perUnit = _registry[node.op].weight * node.load * _childEttSum(node)
    if node.total >= 0:
        node.ett = node.total * perUnit
        node.eta = (node.total - node.gone) * perUnit
    else:
        node.ett = node.eta = -1


def updateAncestor(node, adjustEta: bool = False):
    parent = node.parent
    while parent:
        idx = parent.nodes.index(node)
        updateNode(parent)
        if adjustEta and parent.total >= 0:
            parent.eta += node.eta - sum(c.ett for c in parent.nodes[: idx + 1])
            if parent.eta < 0:
                parent.eta = parent.ett * (parent.total - parent.gone) / parent.total
        node, parent = parent, parent.parent


def initialETA(node) -> float:
    node.gone = 0
    inner = sum(initialETA(c) for c in node.nodes) if node.nodes else 1
    base = _registry[node.op].weight * node.load * max(0, node.total - node.gone)
    node.eta = base * inner if node.total >= 0 else -1
    node.ett = node.eta
    return node.ett


def setCallback(node, callback, all: bool = False, bench: bool = False):
    """Give ``node`` and its descendants (the named ones, or ``all``)
    ``callback``."""
    def walk(n):
        if all or hasattr(n, "name"):
            n.setCallback(callback, bench)
        for c in n.nodes:
            walk(c)

    walk(node)


def recurse(f):
    """A function that applies ``f`` to a node and all its descendants,
    parents first."""
    def walk(n):
        f(n)
        for c in n.nodes:
            walk(c)

    return walk


# --- spans and counters -----------------------------------------------------

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while the torch profiler records,
    else a shared no-op context."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _NO_SPAN


def count(name: str, n: int):
    """Record ``n`` as a zero-length range ``moe.count.<name>=<n>`` while
    the torch profiler records."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(f"moe.count.{name}={n}"):
            pass


def stepName(define: dict) -> str:
    """``moe.step.<op>`` of a node's op dict (see the module's docstring)."""
    if "op" in define:
        return f"moe.step.{define['op']}"
    item = next(iter(define.items()), None)
    return f"moe.step.{item[0]}.{item[1]}" if item else "moe.step.node"


def settle(result):
    """Wait for the device work behind ``result`` when it is a tensor
    that does not live on the CPU."""
    if isinstance(result, torch.Tensor) and result.device.type != "cpu":
        with span("moe.sync"):
            torch.cuda.synchronize(result.device)
    return result


class Node:
    """One pipeline stage in the progress tree."""

    def __init__(self, op: dict, load=1, total=1, learn=30, callback=NullFunc, name=None):
        self.load = load
        self.total = total
        self.gone = 0
        self.ett = 0.0
        self.eta = 0.0
        self.mark = 0.0
        self.parent = None
        self.bench = False
        self.learn = learn or 0
        self.callback = callback
        self.nodes: List[Node] = []
        if name is not None:
            self.name = name
        self.op = opKey(op)
        _statsFor(op, learn)

    def append(self, child: "Node") -> "Node":
        self.nodes.append(child)
        child.parent = self
        return self

    def remove(self, update: bool = False):
        """Detach from the parent; ``update`` re-sums the parent's and its
        ancestors' estimates."""
        parent = self.parent
        parent.nodes.remove(self)
        self.parent = None
        if update:
            updateNode(parent)
            updateAncestor(parent)

    def moveTo(self, target: "Node", pos: int = -1):
        """Re-parent under ``target`` at ``pos`` (-1 = last)."""
        changed = self.parent != target
        if self.parent:
            self.remove(changed)
        if pos < 0:
            target.append(self)
        else:
            target.nodes.insert(pos, self)
            self.parent = target
        if changed:
            updateAncestor(self)

    def setCallback(self, callback=NullFunc, bench: bool = False):
        stats = _registry[self.op]
        self.callback = NullFunc if stats.op.get("op", "") in SILENT_OPS else callback
        self.bench = bench and self.learn
        if self.bench:
            self.learn = float("inf")

    def multipleLoad(self, scale=1):
        if self.nodes:
            for child in self.nodes:
                child.multipleLoad(scale)
        else:
            self.load *= scale

    def reset(self) -> "Node":
        self.gone = 0
        stats = _registry[self.op]
        self.ett = stats.weight * self.load * max(0, self.total) * _childEttSum(self)
        self.eta = self.ett
        return self

    def trace(self, progress=1, **info):
        """Advance by ``progress`` units, learn timing, notify."""
        global _dirty
        self.gone += progress
        stats = _registry[self.op]
        if self.learn > stats.samples:
            now = time.perf_counter()
            if progress > 0:
                elapsed = now - self.mark
                if self.load > 0:
                    stats.addSample(elapsed / self.load / progress)
                if stats.samples >= self.learn:
                    self.learn = False
                    _dirty = True
                if self.bench:
                    info.update(stats.serialize())
            self.mark = now
        if progress > 0:
            updateNode(self)
            updateAncestor(self, True)
        return self.callback(self, info)

    def bindFunc(self, f: Callable) -> Callable:
        name = stepName(_registry[self.op].op)

        def wrapped(*args, **kwargs):
            with span(name):
                self.reset()
                self.trace(0)
                result = settle(f(*args, **kwargs))
                self.trace()
            return result

        return wrapped

    def update(self, content: dict):
        """Overwrite fields (an ``op`` dict is keyed) and re-sum the
        estimates up the tree."""
        if "op" in content:
            content["op"] = opKey(content["op"])
        self.__dict__.update(content)
        updateNode(self)
        updateAncestor(self)

    def toStop(self):
        """End this node after the current unit and report it."""
        self.total = self.gone + 1
        return self.trace(0)
