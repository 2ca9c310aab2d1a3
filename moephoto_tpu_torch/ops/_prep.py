"""Per-module store of what a kernel reads, prepared once from parameters."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch


class PrepCache:
    """Per-module store of prepared kernel inputs.  ``get(key, tensors,
    build)`` returns what ``build()`` made for ``key`` while every tensor
    of ``tensors`` is the same storage at the same version; an in-place
    write (``load_state_dict``, an optimiser step) bumps the version and a
    move or cast (``Module.to``) replaces the storage, so either makes the
    next ``get`` build anew.  ``clear()`` drops everything."""

    def __init__(self):
        self._store: Dict[object, Tuple[tuple, object]] = {}

    @staticmethod
    def stamp(tensors: Sequence[torch.Tensor]) -> tuple:
        # tensors made under inference_mode keep no version: nothing can write to them in place
        return tuple((t.data_ptr(), -1 if t.is_inference() else t._version, t.dtype, t.device) for t in tensors)

    def get(self, key, tensors: Sequence[torch.Tensor], build: Callable[[], object]):
        stamp = self.stamp(tensors)
        hit = self._store.get(key)
        if hit is None or hit[0] != stamp:
            hit = (stamp, build())
            self._store[key] = hit
        return hit[1]

    def clear(self):
        self._store.clear()

    def __len__(self):
        return len(self._store)
