"""Device meshes for the multi-device serving layer.

The JAX package's mesh (``moephoto_tpu/parallel/mesh.py``) is
single-controller: one process holds a ``jax.sharding.Mesh`` and
``shard_map`` runs one function per shard.  The port mirrors that with no
process group: a :class:`Mesh` is an array of ``torch.device``s with axis
names, and per-shard work runs on the shard's device from the one process
(``parallel/sharded.py``).  A device may repeat in a mesh: ``cpu`` x 8 is
the counterpart of XLA's forced host device count, and ``cuda:0`` x 2
places two row shards on one card, so one card runs, and measures, every
sharded path.  On several cards a halo exchange is a peer copy.

``torch.distributed`` is not used: the product is one worker process, NCCL
refuses two ranks on one GPU, and gloo's point-to-point ops take CPU
tensors only.
"""

from __future__ import annotations

import copy
import logging
import math
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.ops._prep import PrepCache


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_replicas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # module -> its copies by device


def replicaOn(model, device):
    """``model`` for work on ``device``: itself when it is no module or its
    weights lie there, else a copy on ``device``, made once per device and
    anew after a write to the weights (a shard's or a tile batch's model
    call on another card of the mesh)."""
    if not isinstance(model, torch.nn.Module):
        return model
    device = canonical(device)
    tensors = list(model.parameters()) + list(model.buffers())
    if not tensors or tensors[0].device == device:
        return model
    copies = _replicas.setdefault(model, PrepCache())
    return copies.get(device, tensors, lambda: copy.deepcopy(model).to(device))


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices: Sequence, shape: Sequence[int], axisNames: Tuple[str, ...]):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        self.devices = arr.reshape(tuple(shape))
        self.axisNames = tuple(axisNames)[: self.devices.ndim]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> List[torch.device]:
        """The devices in row-major order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axisNames, self.shape))}, {[str(d) for d in self.flat]})"


def makeMesh(shape: Optional[Sequence[int]] = None, axisNames: Tuple[str, ...] = ("dp", "sp"),
             devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device) reshaped to
    ``shape``; ``shape=None`` puts every device on the leading axis.  A
    device may appear more than once."""
    devices = list(devices) if devices is not None else [torch.device("cuda", i)
                                                          for i in range(torch.cuda.device_count())]
    if not shape:
        shape = [len(devices)] + [1] * (len(axisNames) - 1)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {list(shape)} does not hold {len(devices)} devices")
    return Mesh(devices, shape, axisNames)


_activeMesh: list = [None, None]  # [cached mesh, cache key]


def _platform() -> str:
    """The platform of ``config.device``, which every mesh device shares."""
    return torch.device(config.device).type


def activeMesh() -> Optional[Mesh]:
    """The serving mesh that ``config.meshShape`` sets (``[8]`` spreads the
    tile batch over 8 devices, ``[2, 4]`` is dp x sp), or None when it is
    unset or the devices do not suffice.  The mesh lies on
    ``config.device``'s platform: the first CUDA cards, or with
    ``config.device = "cpu"`` that many CPU entries (the counterpart of
    XLA's forced host device count, the tests' mesh).  Cached by (shape,
    platform)."""
    shape = tuple(getattr(config, "meshShape", ()) or ())
    if not shape or math.prod(shape) <= 1:
        return None
    key = (shape, _platform())
    if _activeMesh[1] == key and _activeMesh[0] is not None:
        return _activeMesh[0]
    n = math.prod(shape)
    if key[1] == "cpu":
        devices = [torch.device("cpu")] * n
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n > len(devices):
        logging.getLogger("Moe").warning(
            "meshShape %s needs %d devices, have %d — running single-device", shape, n, len(devices))
        return None
    mesh = makeMesh(list(shape), devices=devices[:n])
    _activeMesh[0], _activeMesh[1] = mesh, key
    return mesh


def installMesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the active mesh: ``config.meshShape`` takes its shape
    and the cache holds it (how a caller builds a mesh of repeated devices,
    e.g. ``cuda:0`` x 2).  Its devices must lie on ``config.device``'s
    platform: a mesh elsewhere would move the work off the device the
    caller asked for.  None clears both."""
    from moephoto_tpu_torch.parallel import temporal

    if mesh is None:
        config.meshShape = []
        _activeMesh[:] = [None, None]
    else:
        if any(d.type != _platform() for d in mesh.flat):
            raise ValueError(f"{mesh} is not on config.device {config.device!r}'s platform")
        config.meshShape = list(mesh.shape)
        _activeMesh[:] = [mesh, (tuple(mesh.shape), _platform())]
    temporal._videoMesh[:] = [None, None]
