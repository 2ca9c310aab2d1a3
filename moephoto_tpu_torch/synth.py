"""Seeded random MoeNet_lite2 weights in torch layout.

The real checkpoints are not part of the repository, so parity runs and
the GPU smoke test use random weights made from a seed.  The draws follow
the JAX package's random lite parameters (``__graft_entry__._lite2Params``)
in the same order, so the same seed gives the same weights in both
packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def synthLite2Params(upscale: int = 2, seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random MoeNet_lite2 ×``upscale`` (OIHW, fp32)."""
    rng = np.random.RandomState(seed)
    nUps = int(upscale).bit_length() - 1
    p: Dict[str, np.ndarray] = {}

    def conv(name, kh, kw, cin, cout, bias=False):
        w = rng.randn(kh, kw, cin, cout).astype(np.float32) * (1.0 / np.sqrt(kh * kw * cin))
        w = w.astype(np.float32)  # the float64 scale promotes; round as jnp.asarray does
        p[name + ".weight"] = np.transpose(w, (3, 2, 0, 1))  # HWIO draw -> OIHW
        if bias:
            p[name + ".bias"] = np.zeros((cout,), np.float32)

    conv("conv_input", 1, 1, 1, 48)
    conv("conv_input2", 1, 1, 48, 48)
    p["relu.weight"] = np.full((1,), 0.25, np.float32)
    for blk in ("convt_F11", "convt_F12", "convt_F13"):
        conv(blk + ".conv_1", 3, 3, 48, 48)
        conv(blk + ".conv_2", 3, 3, 48, 48)
        p[blk + ".relu.weight"] = np.full((1,), 0.25, np.float32)
        conv(blk + ".se.conv_du.0", 1, 1, 48, 3, bias=True)
        conv(blk + ".se.conv_du.2", 1, 1, 3, 48, bias=True)
    for path in ("ures", "uim"):
        for i in range(nUps):
            conv(f"{path}.{i}.0", 1, 1, 48, 192, bias=True)
            p[f"{path}.{i}.2.weight"] = np.full((1,), 0.25, np.float32)
    conv("convt_R1", 1, 1, 48, 1)
    conv("convt_I1", 1, 1, 48, 1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
