"""Streaming dataflow runtime for temporal video models.

An eager scheduler, as in the JAX package (``moephoto_tpu/engine/stream.py``):
stages advance in rounds until quiescent.  Streams hold frames (tensors
on the compute device, or host objects); stage functions are plain
PyTorch calls, and all dynamism (windows, padding, dedupe) lives on the
host.

Semantics kept from the reference's pull-driven graphs
(``imageProcess.py:407-537``):
  - sliding windows of ``window`` frames per output (``wm1`` logic),
  - ``reserve`` frames kept across pops for end padding,
  - start/end reflection padding with the reference's index formula
    (``StreamState.pad`` :447-459),
  - sources that never exhaust (time embedding, keyframe markers).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from moephoto_tpu_torch.progress import span


class RowRef:
    """Lazy reference to row ``i`` of a batched stage output: a batch put
    into a stream is stored as row references, and pops re-merge
    contiguous runs into single slices instead of one slice per row."""

    __slots__ = ("ref", "i")

    def __init__(self, ref, i: int):
        self.ref = ref
        self.i = i

    def get(self):
        return self.ref[self.i]


def materialize(item):
    """A single stream item as a real tensor (RowRef -> row slice)."""
    return item.get() if isinstance(item, RowRef) else item


def stackBatch(items):
    """Stack stream items into a (len(items), ...) tensor with as few
    device ops as possible: contiguous RowRef runs of the same source
    become single slices (the whole tensor when it is covered exactly);
    loose items are stacked in one group per run."""
    parts: List = []
    run = None  # (ref, start, stop) for a RowRef run
    loose: List = []  # consecutive non-RowRef items

    def flushRun():
        nonlocal run
        if run is not None:
            ref, a, b = run
            parts.append(ref if (a, b) == (0, ref.shape[0]) else ref[a:b])
            run = None

    def flushLoose():
        nonlocal loose
        if loose:
            parts.append(torch.stack(loose))
            loose = []

    for it in items:
        if isinstance(it, RowRef):
            flushLoose()
            if run is not None and run[0] is it.ref and run[2] == it.i:
                run = (run[0], run[1], it.i + 1)
            else:
                flushRun()
                run = (it.ref, it.i, it.i + 1)
        else:
            flushRun()
            loose.append(it)
    flushRun()
    flushLoose()
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def stackRuns(items, n, T, shape, dtype=torch.float32, device=None):
    """``stackBatch``'s sibling for (ref, idx)-tuple items, with
    None -> zeros and tail padding to ``T`` rows: the first ``n`` items
    become a (T, *shape) tensor, contiguous runs of one source merged
    into single slices and consecutive Nones into one zeros block.  Zeros
    go on the device of the sources (``device`` when there is none)."""
    parts: List = []
    run = None  # (ref, start, stop)
    zeros = 0
    for it in items[:n]:
        if it is not None:
            device = it[0].device
            break

    def flushRun():
        nonlocal run
        if run is not None:
            ref, a, b = run
            seg = ref[a:b] if (a, b) != (0, ref.shape[0]) else ref
            parts.append(seg if seg.dtype == dtype else seg.to(dtype))
            run = None

    def flushZeros():
        nonlocal zeros
        if zeros:
            parts.append(torch.zeros((zeros,) + tuple(shape), dtype=dtype, device=device))
            zeros = 0

    for it in items[:n]:
        if it is None:
            flushRun()
            zeros += 1
            continue
        ref, i = it
        flushZeros()
        if run is not None and run[0] is ref and run[2] == i:
            run = (run[0], run[1], i + 1)
        else:
            flushRun()
            run = (ref, i, i + 1)
    flushRun()
    zeros += T - n
    flushZeros()
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class Stream:
    """A buffered frame stream (reference ``StreamState``)."""

    def __init__(
        self,
        window: Optional[int] = None,
        reserve: int = 0,
        batchFunc: Optional[Callable] = None,
        tensor: bool = True,
        store: bool = True,
        name: Optional[str] = None,
    ):
        self.wm1 = (window - 1) if window else 0
        self.reserve = reserve
        self.tensor = tensor
        self.store = store
        self.batchFunc = batchFunc if batchFunc else (stackBatch if tensor else (lambda x: x))
        self.name = name
        self.state: List = []
        self.stateR: List = []
        self.startPad = 0
        self.endPad = 0
        self.sink: Optional[List] = None  # set for sink streams

    # -- sizing ------------------------------------------------------------
    def avail(self, size: int = 0) -> int:
        ls = len(self.state)
        if ls < self.wm1 + (size or 1) or self.startPad:
            return 0
        lb = ls - self.wm1
        return min(size, lb) if size else lb

    # -- padding (reference ``pad`` imageProcess.py:447-459) ---------------
    def _pad(self, padding: int) -> int:
        if padding == 0:
            return 0
        absPad = abs(padding)
        if len(self.stateR) + len(self.state) < 1 + absPad * 2:
            return 0
        offset = padding - 2 if padding < 0 else 0
        ids = [int(i) + padding + offset for i in range(absPad, 0, -1)]
        state = self.stateR + self.state
        batch = [state[i] for i in ids]
        self.state = (self.state + batch) if padding < 0 else (batch + self.state)
        return padding

    def setPadding(self, padding: int):
        if padding > 0:
            self.startPad = padding
        elif padding < 0:
            self.endPad = padding
        return self

    def applyEndPad(self):
        if self.endPad:
            self.endPad -= self._pad(self.endPad)

    # -- IO ----------------------------------------------------------------
    def put(self, batch):
        if batch is None:
            return None
        if self.sink is not None:
            ext = batch if isinstance(batch, list) else list(batch)
            self.sink.extend(materialize(t) for t in ext)
            return batch
        if self.store:
            if self.tensor and isinstance(batch, torch.Tensor):
                # lazy row refs: pops re-merge contiguous runs into slices
                self.state.extend(RowRef(batch, i) for i in range(batch.shape[0]))
            else:
                self.state.extend(t for t in batch)
        if self.startPad:
            self.startPad -= self._pad(self.startPad)
        return batch

    def _window(self, r: int):
        """The r sliding windows over state, each already batched.  Tensor
        windows build column-wise: column j (state[i + j] for every window
        i) is one run-merged slice, and one stack along axis 1 gives
        (r, window, ...)."""
        w = self.wm1 + 1
        if self.batchFunc is stackBatch:
            cols = [stackBatch(self.state[j : j + r]) for j in range(w)]
            return torch.stack(cols, dim=1)  # (r, w, ...)
        return [self.batchFunc([materialize(t) for t in self.state[i : i + w]]) for i in range(r)]

    def _popCommon(self, size: int):
        r = self.avail(size)
        if not r:
            return None, 0
        if self.wm1:
            batch = self._window(r)
        else:
            batch = self.state[:r]
        if self.reserve:
            self.stateR = (self.stateR + self.state[r - self.reserve : r])[-self.reserve :]
        self.state = self.state[r:]
        return batch, r

    def pop(self, size: int = 1):
        batch, r = self._popCommon(size)
        if not r:
            return None
        if self.wm1:
            # tensor windows are already the (r, w, ...) tensor
            return batch if self.batchFunc is stackBatch else self.batchFunc(batch)
        if self.batchFunc is stackBatch:
            return stackBatch(batch)
        return self.batchFunc([materialize(t) for t in batch])

    def popItems(self, size: int = 1):
        """Like ``pop`` but without the outer batchFunc: the item list
        itself (window streams still apply the per-window batchFunc).  Tees
        use it to move items by reference."""
        batch, r = self._popCommon(size)
        if not r:
            return None
        if self.wm1 and self.batchFunc is stackBatch:
            return [RowRef(batch, i) for i in range(r)]
        return batch

    def __len__(self):
        return self.avail()


class InfiniteSource:
    """Base for never-exhausting sources (the time embedding)."""

    def avail(self, size: int = 0) -> int:
        return size or (1 << 30)

    def applyEndPad(self):
        pass

    endPad = 0
    startPad = 0

    def pop(self, size: int = 1):  # pragma: no cover - abstract
        raise NotImplementedError


class Stage:
    """One computation: pops aligned batches from ``ins`` and pushes the
    result to every stream in ``outs``."""

    def __init__(
        self,
        fn: Callable,
        ins: Sequence,
        outs: Sequence[Stream],
        size: int = 1,
        args: Sequence = (),
        flushOnce: bool = False,
        raw: bool = False,
    ):
        self.fn = fn
        self.ins = list(ins)
        self.outs = list(outs)
        # size=0: drain mode, fire on any r >= 1 and pop everything (tees)
        self.size = size if size else 1
        self.drain = size == 0
        self.args = list(args)
        # raw: pop item lists (Stream.popItems), so tees move by reference
        self.raw = raw
        # flushOnce: the reference's pull scheduler shows such a stage
        # last=True on its final real batch; the eager scheduler may have
        # consumed everything already, so the stage is called one extra
        # time at flush with all-None batches to emit its tail (dedupe
        # residue, trailing flows, backward pads).
        self.flushOnce = flushOnce
        self._flushed = False

    def advance(self, last: bool) -> bool:
        r = min(s.avail() for s in self.ins)
        if r < self.size and not (r and last):
            if last:
                for s in self.ins:
                    s.applyEndPad()
                r = min(s.avail() for s in self.ins)
                if not r:
                    if self.flushOnce and not self._flushed:
                        self._flushed = True
                        out = self.fn(*self.args, *(None for _ in self.ins), last=True)
                        if out is not None:
                            for s in self.outs:
                                s.put(out)
                            return True
                    return False
            else:
                return False
        if not self.drain:
            r = min(r, self.size)
        batches = [(s.popItems(r) if self.raw else s.pop(r)) for s in self.ins]
        out = self.fn(*self.args, *batches, last=last)
        if out is None:
            return True
        for s in self.outs:
            s.put(out)
        return True


class StreamGraph:
    """Eager scheduler: after each frame push (or during flush), advance
    stages round-robin until quiescent.

    A stage may only see ``last=True`` once every transitive producer has
    drained (the reference's demand-driven ``pull``, imageProcess.py
    :481-515), so the flush is phased by dataflow depth: stages at depth
    <= d flush before any stage at depth d + 1 sees ``last``.
    """

    def __init__(self):
        self.stages: List[Stage] = []
        self._producer = {}  # id(stream) -> producing stage

    def stage(self, fn, ins, outs, size=1, args=(), flushOnce=False, raw=False) -> Stage:
        st = Stage(fn, ins, outs, size, args, flushOnce, raw)
        self.stages.append(st)
        for o in st.outs:
            self._producer[id(o)] = st
        return st

    def tee(self, src: Stream, dsts: Sequence[Stream]):
        """Identity fan-out: items move by reference (raw pop of all
        available, list put)."""
        return self.stage(lambda batch, last=None: batch, [src], dsts, size=0, raw=True)

    def _depth(self, st: Stage, memo) -> int:
        if id(st) in memo:
            return memo[id(st)]
        memo[id(st)] = 0  # break accidental cycles
        ds = [self._depth(self._producer[id(i)], memo) + 1 for i in st.ins if id(i) in self._producer]
        memo[id(st)] = max(ds) if ds else 0
        return memo[id(st)]

    def _round(self, lastDepth: int, memo) -> bool:
        progress = False
        for st in self.stages:
            if st.advance(self._depth(st, memo) <= lastDepth):
                progress = True
        return progress

    def run(self, last: bool = False):
        with span("moe.stream.run"):
            memo = {}
            while self._round(-1, memo):
                pass
            if last:
                maxDepth = max((self._depth(st, memo) for st in self.stages), default=0)
                for d in range(maxDepth + 1):
                    while self._round(d, memo):
                        pass
