"""Hierarchical progress tracking with an online per-op time model.

Every pipeline stage is a node in a tree; finishing work on a node
updates an exponentially averaged seconds-per-load estimate for that op
kind, and estimates bubble up the tree as ETAs.

On the GPU a step returns as soon as its kernels are queued, so
:meth:`Node.bindFunc` waits for a device result before it traces: each
node then learns the time of its own work, instead of the first step
that copies to the host learning the time of all steps before it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

EMA_KEEP = 0.9  # weight retained per new sample


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
        self.samples += 1
        if self.samples <= 2:
            self.weight = secondsPerLoad
        else:
            self.weight = EMA_KEEP * self.weight + (1 - EMA_KEEP) * secondsPerLoad

    def serialize(self) -> dict:
        return dict(op=self.op, weight=self.weight, samples=self.samples)


_registry: Dict[int, OpStats] = {}

opKey = lambda define: hash(frozenset(define.items()))
NullFunc = lambda *args: None


def _statsFor(define: dict, learn) -> OpStats:
    key = opKey(define)
    st = _registry.get(key)
    if st is None:
        st = _registry[key] = OpStats(define, learn)
    return st


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


def settle(result):
    """Wait for the device work behind ``result`` when it is a tensor
    that does not live on the CPU."""
    if isinstance(result, torch.Tensor) and result.device.type != "cpu":
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

    def reset(self) -> "Node":
        self.gone = 0
        stats = _registry[self.op]
        self.ett = stats.weight * self.load * max(0, self.total) * _childEttSum(self)
        self.eta = self.ett
        return self

    def trace(self, progress=1, **info):
        """Advance by ``progress`` units, learn timing, notify."""
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
                if self.bench:
                    info.update(stats.serialize())
            self.mark = now
        if progress > 0:
            updateNode(self)
            updateAncestor(self, True)
        return self.callback(self, info)

    def bindFunc(self, f: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            self.reset()
            self.trace(0)
            result = settle(f(*args, **kwargs))
            self.trace()
            return result

        return wrapped
