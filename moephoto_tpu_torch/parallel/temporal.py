"""Row-sharded execution of the video stages.

The recurrences of the video models run in time, but every stage is
convolutional over (H, W), so image rows shard across the whole mesh
(``moephoto_tpu/parallel/temporal.py``).  There XLA's partitioner inserts
the halo exchanges; here each stage has a sharded form written with
``parallel/sharded.py`` (segments with a stated row reach, reductions
summed per shard, warps and DCN through the ops' sharded forms), and
:func:`rowStage` picks it: with no mesh a stage is its plain call.

The ops take the kernel or the plain version by the device a shard lies on,
as everywhere in the port, so the JAX package's ``pallasSpmdMode`` switch
has no counterpart; :func:`spmdTracing` says that a sharded stage runs, for
ops given whole tensors inside one (``models/ailut.py``, ``ops/deform.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from moephoto_tpu_torch.parallel.mesh import Mesh, activeMesh
from moephoto_tpu_torch.parallel.sharded import RowShards

_spmdTracing = [False]
_videoMesh: list = [None, None]  # [mesh, key]


def spmdTracing() -> bool:
    """True while a row-sharded stage runs."""
    return _spmdTracing[0]


def videoMesh() -> Optional[Mesh]:
    """``config.meshShape`` flattened to a 1-d ('sp',) row mesh (video
    stages have no batch axis to shard), or None."""
    base = activeMesh()
    if base is None or base.size <= 1:
        return None
    key = id(base)
    if _videoMesh[1] != key:
        _videoMesh[0], _videoMesh[1] = Mesh(base.flat, (base.size,), ("sp",)), key
    return _videoMesh[0]


def shardArg(a, h: Optional[int], mesh: Mesh, align: int):
    """An argument placed for a sharded stage: a tensor cut into row shards
    on axis ``h``; RowShards, and anything with ``h`` None, as they are."""
    if h is None or isinstance(a, RowShards):
        return a
    return RowShards.split(a, mesh.flat, h, align)


def gatherOut(o):
    """A stage output gathered whole on its first device."""
    if isinstance(o, RowShards):
        return o.gather()
    if isinstance(o, (list, tuple)):
        return type(o)(gatherOut(x) for x in o)
    return o


def rowStage(plain: Callable, sharded: Callable, hAxes: Sequence[Optional[int]],
             outHAxes: Optional[Sequence[Optional[int]]] = None, align: int = 1) -> Callable:
    """The counterpart of the JAX package's ``stageJit``: with no mesh the
    stage is ``plain(*args)``.  With one, each positional argument whose ``hAxes``
    entry names a row axis is cut into row shards (multiples of ``align``
    rows) and ``sharded(*args)`` runs; its outputs whose ``outHAxes`` entry
    is None are gathered, the others stay row shards, so the next stage
    takes them without a copy (``outHAxes`` None gathers everything)."""
    hAxes = tuple(hAxes)

    def call(*args, **kw):
        mesh = videoMesh()
        if mesh is None:
            return plain(*args, **kw)
        if len(args) > len(hAxes):
            raise TypeError(f"{len(args)} arguments for {len(hAxes)} row axes")
        placed = [shardArg(a, h, mesh, align) for a, h in zip(args, hAxes)]
        _spmdTracing[0] = True
        try:
            out = sharded(*placed, **kw)
        finally:
            _spmdTracing[0] = False
        if outHAxes is None:
            return gatherOut(out)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        outs = tuple(o if h is not None else gatherOut(o) for o, h in zip(outs, outHAxes))
        return outs[0] if single else outs

    return call
