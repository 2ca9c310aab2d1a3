"""Worker-process task runtime.

The worker side of the two-process app: it owns the progress tree,
decorates task handlers with structured error capture, and serves the
requests that arrive over the task pipe.  Progress callbacks stream
``{eta, gone, total, stage}`` dicts to the server through the notifier
pipe; learned op timings persist through ``progress.saveOps``.

Between tasks the worker runs a garbage-collection pass and, when a card
is in use, empties PyTorch's CUDA allocator cache, as the reference
emptied its allocator between tasks.
"""

from __future__ import annotations

import gc
import logging
from traceback import format_exc

import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.progress import clearOps, initialETA, loadOps, saveOps, setCallback
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.utils.logger import initLogging

log = logging.getLogger("Moe")


def _describeCall(f, args):
    """Loggable call signature with model opts elided.

    Dict args are COPIED here: genProcess attaches live ``ModelExec``
    objects ('opt', whose modules live on the card) to the step dicts it
    receives, so a description that aliased them would become
    unpicklable the moment the task starts, and the failure reply that
    carries it would break the worker's result pipe."""

    def strip(a):
        if isinstance(a, dict):
            return {k: v for k, v in a.items() if k != "opt"}
        return a

    return [f.__name__] + [strip(a) for a in args]


filterOpt = lambda item: _describeCall(lambda: 0, [item])[1]
getInfo = _describeCall


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


def clean():
    """Release the previous task's intermediates promptly: a GC pass, then
    the CUDA allocator's cached blocks when a card is in use."""
    gc.collect()
    if torch.device(config.device).type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def enhance(f, verbose=True):
    """Decorate a task handler to return ``(body, status)``.

    Success: ``{'result': ...}, 200`` (and the op-timing file is
    flushed); any exception: ``{'result': 'Fail', 'call', 'exception'},
    400``, also pushed through the notifier so the client sees the
    failure without polling.
    """

    def run(*args, **kwargs):
        called = _describeCall(f, args)
        try:
            body = {"result": f(*args, **kwargs)}
            saveOps(config.opsPath, True)
            if verbose:
                log.info(called)
            return body, 200
        except Exception:  # the request loop must keep serving
            log.exception(called)
            body = {"result": "Fail", "call": called, "exception": format_exc()}
            _notify(body)
            return body, 400
        finally:
            clean()

    return run


def worker(main, taskIn, taskOut, notifier, stopEvent, isWindows):
    """Blocking request loop over the task pipe.

    ``main()`` returns the shared-memory handle and the route table;
    each message is ``(routeName, *args)`` and the handler's
    ``(body, status)`` is sent straight back.
    """
    initLogging(config.logPath)
    mm, routes = main()
    if isWindows:
        context.shared, context.sharedView = mm, memoryview(mm)
    else:
        context.shared, context.sharedView = mm.buf.obj, mm.buf
    context.shared.seek(0)
    context.notifier = notifier
    context.stopFlag = stopEvent
    loadOps(config.opsPath)
    while True:
        name, *args = taskIn.recv()
        stopEvent.clear()
        taskOut.send(routes[name](*args))
