"""Worker-side task runtime: the progress tree and its callbacks.

Ported so far: :func:`begin`, which the video engine calls to root a
task's progress tree, and the callback that reports it
(:func:`onProgress`) through the notifier.  The request loop waits for
the server slice.
"""

from __future__ import annotations

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.progress import clearOps, initialETA, saveOps, setCallback
from moephoto_tpu_torch.runtime.context import context


def _notify(payload: dict):
    if context.notifier is not None:
        context.notifier.send(payload)


def onProgress(node, kwargs={}):
    """Progress-tree callback: the root's ETA summary and per-stage detail;
    learned op timings go to ``config.opsPath``."""
    root = context.root
    payload = dict(eta=root.eta, gone=root.gone, total=root.total) if root else {}
    payload.update(kwargs)
    saveOps(config.opsPath)
    if hasattr(node, "name") and node.gone < node.total:
        payload["stage"] = node.name
        if node.total > 1:
            payload["stageProgress"] = node.gone
            payload["stageTotal"] = node.total
    _notify(payload)


def begin(root, nodes=[], setAllCallback=True, bench=False, clear=False):
    """Rebuild the progress tree under ``root`` and wire callbacks.

    ``setAllCallback``: truthy, every named node reports; falsy, only the
    root; negative, reporting is off (headless bench runs).
    """
    context.root = root
    root.nodes = []
    for node in nodes:
        root.append(node)
    if not setAllCallback:
        root.setCallback(onProgress)
    elif setAllCallback > 0:
        setCallback(root, onProgress, True, bench)
    clearOps(root, clear)
    initialETA(root)
    return root
