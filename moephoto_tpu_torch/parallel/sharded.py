"""Row-sharded execution over a mesh: row shards, halo exchange, and the
one primitive every row-sharded stage is written in.

The JAX package shards image rows over the mesh's ``sp`` axis and lets
``shard_map`` with ``ppermute`` (``moephoto_tpu/parallel/sharded.py``) or
GSPMD move the halos.  PyTorch has no partitioner, so here a sharded
stage is written out: a tensor is a :class:`RowShards` (one part per mesh
device, each the rows [a, b) of the global tensor), a halo is a slice of
the neighbouring parts copied to the shard's device (a peer copy across
cards, a device-local copy on one), and a convolutional segment runs
through :func:`rowSegment`: the shard's rows plus ``halo`` rows from each
side, the segment on the shard's device, ``halo * scale`` rows cropped.

A shard on a global edge takes no halo on that side, so every conv pads
exactly as the single-device run does (a zero halo would not: bias and
PReLU turn zero rows into non-zero rows for the next conv).  Row splits
are multiples of the stage's alignment and may be uneven.  Where a shard
is shorter than a segment's halo, the segment runs gathered on the first
shard's device and is split again (the counterpart of JAX replicating
rows that do not divide); :data:`stats` counts every such gather, every
host read and the bytes moved between shards.  Under
:func:`checkingSegments` every segment that runs sharded runs whole as
well, and the segments whose outputs differ are counted.

Training runs on the same shards: :func:`makeShardedLoss` is the L1 loss
over a (dp, sp) mesh, with autograd through the halo copies and the
per-device casts of the parameters, and :func:`makeShardedTrainStep` and
:func:`makeOptaxTrainStep` step on its gradient.
"""

from __future__ import annotations

import contextlib
from fractions import Fraction
from typing import Callable, List, Optional, Sequence

import torch

from moephoto_tpu_torch.models.api import fullFp32

# counters of the sharded paths: "gathers" (segments run gathered),
# "hostReads" (device -> host reads that size a halo), "haloBytes" (bytes
# copied from one shard's part into another shard's window), "tileCalls"
# (model calls of the tiled engine, per mesh slot), "segments" (under
# :func:`checkingSegments`: per segment, its sharded calls and the calls
# whose output differs from the whole run's)
stats: dict = {}
_checking = [False]


def resetStats() -> None:
    stats.clear()
    stats.update(gathers=0, hostReads=0, haloBytes=0, tileCalls={}, segments={})


@contextlib.contextmanager
def checkingSegments():
    """While entered, every segment :func:`rowSegment` runs sharded runs a
    second time on the gathered input, and ``stats["segments"]`` maps each
    segment (its function's name, input shape, halo and scale) to [calls,
    calls whose sharded output differs from the whole one in any bit, a NaN
    matching a NaN].  In bf16 a conv can round apart on a shard's window,
    where cuDNN picks another algorithm by the shape; this finds the
    segments that do.  The outputs stay the sharded ones."""
    _checking[0] = True
    try:
        yield
    finally:
        _checking[0] = False


def _checkSegment(fn: Callable, x: "RowShards", out: "RowShards", halo: int, scale) -> None:
    whole = fn(x.gather())
    got = out.gather(whole.device)
    differ = bool(((got != whole) & ~(got.isnan() & whole.isnan())).any())
    calls = stats["segments"].setdefault(f"{fn.__qualname__} in {list(x.shape)} halo {halo} scale {scale}", [0, 0])
    calls[0] += 1
    calls[1] += differ


resetStats()


def rowBounds(rows: int, n: int, align: int = 1) -> List[int]:
    """Row starts of at most ``n`` shards of ``rows`` rows, each a multiple
    of ``align`` rows, as even as that allows (the first shards take one
    block more); fewer shards when there are fewer blocks than ``n``.
    Returns the n + 1 bounds."""
    if rows % align:
        raise ValueError(f"{rows} rows are no multiple of the alignment {align}")
    blocks = rows // align
    m = max(1, min(n, blocks))
    q, r = divmod(blocks, m)
    bounds = [0]
    for j in range(m):
        bounds.append(bounds[-1] + (q + (j < r)) * align)
    return bounds


class RowShards:
    """A tensor cut along ``axis`` into row shards: ``parts[j]`` holds the
    global rows [bounds[j], bounds[j + 1]) on its own device."""

    __slots__ = ("parts", "bounds", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], bounds: Sequence[int], axis: int):
        self.parts = list(parts)
        self.bounds = tuple(int(b) for b in bounds)
        self.axis = axis
        if len(self.bounds) != len(self.parts) + 1:
            raise ValueError(f"{len(self.parts)} parts, bounds {self.bounds}")
        for p, a, b in zip(self.parts, self.bounds, self.bounds[1:]):
            if p.shape[axis] != b - a:
                raise ValueError(f"part of {p.shape[axis]} rows for rows [{a}, {b}) on axis {axis}")

    @staticmethod
    def split(x: torch.Tensor, devices: Sequence[torch.device], axis: int, align: int = 1,
              bounds: Optional[Sequence[int]] = None) -> "RowShards":
        """``x`` cut into row shards over ``devices`` (see :func:`rowBounds`,
        or at ``bounds``); a part on ``x``'s own device is a view."""
        if bounds is None:
            bounds = rowBounds(x.shape[axis], len(devices), align)
        parts = [x.narrow(axis, a, b - a).to(d, non_blocking=True)
                 for d, a, b in zip(devices, bounds, bounds[1:])]
        return RowShards(parts, bounds, axis)

    @property
    def n(self) -> int:
        return len(self.parts)

    @property
    def rows(self) -> int:
        return self.bounds[-1]

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def shape(self):
        s = list(self.parts[0].shape)
        s[self.axis] = self.rows
        return torch.Size(s)

    def rowsOf(self, j: int):
        return self.bounds[j], self.bounds[j + 1]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first part's)."""
        device = self.parts[0].device if device is None else torch.device(device)
        return torch.cat([p.to(device, non_blocking=True) for p in self.parts], self.axis)

    def map(self, fn: Callable, axis: Optional[int] = None) -> "RowShards":
        """``fn`` on every part; the rows stay (they move to ``axis``)."""
        return RowShards([fn(p) for p in self.parts], self.bounds, self.axis if axis is None else axis)

    def window(self, j: int, lo: int, hi: int) -> torch.Tensor:
        """Global rows [lo, hi) on part j's device, taken from as many parts
        as they span; a view when part j holds them all."""
        dev = self.parts[j].device
        pieces = []
        for k, (a, b) in enumerate(zip(self.bounds, self.bounds[1:])):
            s, e = max(lo, a), min(hi, b)
            if s >= e:
                continue
            piece = self.parts[k].narrow(self.axis, s - a, e - s)
            if k != j:
                stats["haloBytes"] += piece.numel() * piece.element_size()
                piece = piece.to(dev, non_blocking=True)
            pieces.append(piece)
        if not pieces or sum(p.shape[self.axis] for p in pieces) != hi - lo:
            raise ValueError(f"rows [{lo}, {hi}) are not inside [0, {self.rows})")
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, self.axis)


def zipShards(fn: Callable, *args, axis: Optional[int] = None) -> "RowShards":
    """``fn`` shard by shard over ``args``: each :class:`RowShards` gives its
    part j, anything else goes as it is.  The RowShards must share bounds
    and devices; the result's rows are on ``axis`` (default the first
    RowShards')."""
    shards = [a for a in args if isinstance(a, RowShards)]
    ref = shards[0]
    for s in shards[1:]:
        if s.bounds != ref.bounds or s.devices != ref.devices:
            raise ValueError(f"row shards differ: {s.bounds} on {s.devices}, {ref.bounds} on {ref.devices}")
    axis = ref.axis if axis is None else axis
    outs = [fn(*(a.parts[j] if isinstance(a, RowShards) else a for a in args)) for j in range(ref.n)]
    return RowShards(outs, ref.bounds, axis)


def scaleBounds(bounds: Sequence[int], scale) -> List[int]:
    """Bounds times ``scale`` (a Fraction), which must give whole rows."""
    out = [Fraction(b) * Fraction(scale) for b in bounds]
    if any(o.denominator != 1 for o in out):
        raise ValueError(f"bounds {list(bounds)} times {scale} are not whole rows")
    return [int(o) for o in out]


def rowSegment(fn: Callable, x: RowShards, halo: int, scale=1, gather: bool = False) -> RowShards:
    """A convolutional segment, row-sharded: on each shard's device ``fn``
    takes the shard's rows with ``halo`` rows from each side (none past a
    global edge) and gives ``scale`` output rows per input row; the
    ``halo * scale`` rows next to each halo are cropped.  ``halo`` is the
    segment's row reach: every output row depends on the input rows within
    ``halo`` of it (in input rows).  Where a shard holds fewer rows than
    ``halo``, or the caller asks for it (``gather``), the segment runs
    gathered on the first device and is split again (counted in
    ``stats["gathers"]``)."""
    scale = Fraction(scale)
    outBounds = scaleBounds(x.bounds, scale)
    if gather or any(b - a < halo for a, b in zip(x.bounds, x.bounds[1:])):
        stats["gathers"] += 1
        y = fn(x.gather())
        return RowShards([y.narrow(x.axis, a, b - a).to(d, non_blocking=True)
                          for d, a, b in zip(x.devices, outBounds, outBounds[1:])], outBounds, x.axis)
    halo = int(halo)
    outs = []
    for j in range(x.n):
        a, b = x.rowsOf(j)
        lo, hi = max(0, a - halo), min(x.rows, b + halo)
        y = fn(x.window(j, lo, hi))
        top = Fraction(a - lo) * scale
        if top.denominator != 1:
            raise ValueError(f"a halo of {a - lo} rows at scale {scale} is not whole rows")
        outs.append(y.narrow(x.axis, int(top), outBounds[j + 1] - outBounds[j]))
    out = RowShards(outs, outBounds, x.axis)
    if _checking[0]:
        _checkSegment(fn, x, out, halo, scale)
    return out


def reflectIndex(n: int, rows: int) -> torch.Tensor:
    """Source rows of ``rows`` rows reflect-padded from ``n`` at the end, as
    ``numpy.pad``'s ``reflect`` (the edge row not repeated, the reflection
    repeated where the pad outgrows the rows)."""
    period = max(1, 2 * (n - 1))
    j = torch.arange(rows) % period
    return torch.where(j >= n, period - j, j)


def padRows(x: RowShards, rows: int) -> RowShards:
    """``x`` reflect-padded at its global bottom to ``rows`` rows
    (:func:`reflectIndex`), the new rows on the last shard, taken from as
    many shards as they reach back into."""
    if rows <= x.rows:
        return x
    src = reflectIndex(x.rows, rows)[x.rows :]
    j, lo = x.n - 1, int(src.min())
    win = x.window(j, lo, int(src.max()) + 1)
    pad = win.index_select(x.axis, (src - lo).to(win.device))
    return RowShards(x.parts[:j] + [torch.cat([x.parts[j], pad], x.axis)], x.bounds[:-1] + (rows,), x.axis)


def haloExchange(x: RowShards, halo: int, mode: str = "reflect") -> List[torch.Tensor]:
    """Each part with ``halo`` rows from its neighbours on each side (from
    as many parts as ``halo`` spans), as ``moephoto_tpu/parallel/sharded.py``
    ``haloExchange`` pads a row shard inside ``shard_map``.  Past a global
    edge the rows are what a single-device pad of the whole tensor gives
    there: ``reflect`` (conv stages), ``edge`` (border-mode warps) or
    ``zero`` (zeros-mode warps, halos that get cropped)."""
    if mode not in ("reflect", "edge", "zero"):
        raise ValueError(mode)
    ax, H, out = x.axis, x.rows, []
    for j in range(x.n):
        a, b = x.rowsOf(j)
        t, u = max(0, halo - a), max(0, b + halo - H)
        mid = x.window(j, max(0, a - halo), min(H, b + halo))
        pieces = []
        if t:
            pieces.append(_edgeRows(x, j, mode, t, top=True))
        pieces.append(mid)
        if u:
            pieces.append(_edgeRows(x, j, mode, u, top=False))
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, ax))
    return out


def _edgeRows(x: RowShards, j: int, mode: str, n: int, top: bool) -> torch.Tensor:
    H, ax = x.rows, x.axis
    if mode == "reflect":
        rows = x.window(j, 1, n + 1) if top else x.window(j, H - 1 - n, H - 1)
        return rows.flip(ax)
    edge = x.window(j, 0, 1) if top else x.window(j, H - 1, H)
    shape = list(edge.shape)
    shape[ax] = n
    return edge.expand(shape) if mode == "edge" else torch.zeros(shape, dtype=edge.dtype, device=edge.device)


def shardedTiledForward(apply: Callable, mesh, halo: int, scale: int = 1) -> Callable:
    """A forward over a (dp, sp) mesh (``moephoto_tpu/parallel/sharded.py``
    ``shardedTiledForward``): (B, H, W, C) -> (B, H * scale, W * scale, C'),
    the batch split over ``dp`` and the rows over ``sp``; each shard takes a
    reflect halo of ``halo`` rows, runs ``apply`` on its device and drops
    ``halo * scale`` rows on each side.  Exact where the model's receptive
    field fits in the halo.  Returns the whole output on the mesh's first
    device."""
    grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
    dp, sp = grid.shape

    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} does not split over dp = {dp}")
        home, per, rowsOut = grid[0, 0], x.shape[0] // dp, []
        for i in range(dp):
            rs = RowShards.split(x[i * per : (i + 1) * per], list(grid[i]), 1)
            ys = []
            for j, padded in enumerate(haloExchange(rs, halo, "reflect")):
                y = apply(padded)
                ys.append(y.narrow(1, halo * scale, padded.shape[1] * scale - 2 * halo * scale).to(home))
            rowsOut.append(torch.cat(ys, 1))
        return torch.cat(rowsOut, 0)

    return forward


def makeShardedLoss(model: torch.nn.Module, mesh, halo: int, scale: int = 1,
                    computeDtype: Optional[torch.dtype] = None) -> Callable:
    """The L1 training loss of ``model`` over a (dp, sp) mesh: the batch
    split over ``dp``, the rows over ``sp``, each shard reflect-padded by
    ``haloExchange`` and run on its device through
    ``torch.func.functional_call`` with the parameters cast there (in
    ``computeDtype`` where given), ``halo * scale`` rows cropped, and the
    fp32 mean of |pred - y| taken on its rows.  The loss is the mean of the
    shards' losses, as the JAX package's ``psum / n``, on the mesh's first
    device.

    Returns ``loss(params, x, y)``: ``params`` maps the model's parameter
    names to tensors, x is (B, H, W, C), y (B, H * scale, W * scale, C).
    Every cast is differentiable, so a backward pass sums each shard's
    gradient onto ``params``: the gradient is that of the loss returned,
    the mean of the shards' gradients."""
    grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
    dp, sp = grid.shape
    home, hs = grid[0, 0], halo * scale

    def loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % dp or x.shape[1] % sp:
            raise ValueError(f"batch {x.shape[0]} and rows {x.shape[1]} do not split over dp x sp = {dp} x {sp}")
        per, onDevice, total = x.shape[0] // dp, {}, 0.0
        for i in range(dp):
            xs = RowShards.split(x[i * per : (i + 1) * per], list(grid[i]), 1)
            ys = RowShards.split(y[i * per : (i + 1) * per], list(grid[i]), 1, bounds=scaleBounds(xs.bounds, scale))
            for padded, target in zip(haloExchange(xs, halo, "reflect"), ys.parts):
                dev = padded.device
                if dev not in onDevice:  # one cast a device: autograd sums its uses
                    onDevice[dev] = {k: p.to(dev, computeDtype or p.dtype) for k, p in params.items()}
                if computeDtype is not None:
                    padded = padded.to(computeDtype)
                pred = torch.func.functional_call(model, onDevice[dev], (padded,))
                pred = pred.narrow(1, hs, pred.shape[1] - 2 * hs)
                total = total + (pred.float() - target.float()).abs().mean().to(home)
        return total / (dp * sp)

    return loss


def _precisionOf(computeDtype):
    # fp32 training is true fp32 on the card: cuDNN would take TF32 otherwise
    return fullFp32() if computeDtype is None else contextlib.nullcontext()


def makeShardedTrainStep(model: torch.nn.Module, mesh, halo: int, scale: int = 1, lr: float = 1e-4) -> Callable:
    """One SGD step of :func:`makeShardedLoss` (the JAX package's
    ``makeShardedTrainStep``): ``step(params, x, y) -> (newParams, loss)``
    with p <- (p32 - lr g32) in each parameter's own dtype, the new
    parameters on the mesh's first device.  g is the gradient of the loss
    returned, which the docstring of the JAX step promises ("gradients
    all-reduced over both mesh axes"); the JAX step applies shard (0, 0)'s
    own gradient instead (ROADMAP Queue C)."""
    lossOf = makeShardedLoss(model, mesh, halo, scale)
    home = mesh.flat[0]

    def step(params, x: torch.Tensor, y: torch.Tensor):
        masters = {k: p.detach().to(home, torch.float32).requires_grad_() for k, p in params.items()}
        with _precisionOf(None):
            loss = lossOf(masters, x, y)
            grads = torch.autograd.grad(loss, list(masters.values()))
        new = {k: (m.detach() - lr * g).to(params[k].dtype) for (k, m), g in zip(masters.items(), grads)}
        return new, loss.detach()

    return step


def makeOptaxTrainStep(model: torch.nn.Module, mesh, optimizer: torch.optim.Optimizer, halo: int, scale: int = 1,
                       computeDtype: Optional[torch.dtype] = None) -> Callable:
    """:func:`makeShardedTrainStep` with a ``torch.optim`` optimizer (the
    JAX package's ``makeOptaxTrainStep`` with an optax one; the fine-tuning
    CLI passes ``torch.optim.Adam``, ``optax.adam``'s formula).  Returns
    ``step(params, x, y) -> (params, loss)``: ``params`` are the fp32
    masters that ``optimizer`` holds, on the mesh's first device, updated
    in place.

    ``computeDtype=torch.bfloat16`` is mixed precision: masters and
    optimizer state stay fp32; each shard's forward and backward run in
    bf16 on the parameters cast there (every weight follows the input, as
    the JAX package's convs cast theirs), FRM's pool sums in fp32, the loss
    is reduced in fp32, and the gradients reach the masters through the
    casts in fp32.  Biases are cast too, as in the port's bf16 inference:
    MoeNet_lite2's up stages round theirs to bf16 where JAX adds them in
    fp32.  The JAX step needs ``trainAccum`` to drop its convs'
    fp32 output pin, because JAX's conv transpose rule cannot type a bf16 x
    fp32 operand mix; here every conv's operands share one dtype, so
    nothing stands in for it.  With ``computeDtype=None`` the step runs in
    true fp32 (``models.api.fullFp32``)."""
    lossOf = makeShardedLoss(model, mesh, halo, scale, computeDtype)

    def step(params, x: torch.Tensor, y: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        with _precisionOf(computeDtype):
            loss = lossOf(params, x, y)
            loss.backward()
        optimizer.step()
        return params, loss.detach()

    return step
