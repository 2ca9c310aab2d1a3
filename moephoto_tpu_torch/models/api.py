"""Layer primitives and weight loading.

Parameters stay in torch layout (Conv2d OIHW, Linear (out, in)) under
the checkpoint's state-dict keys, so a module's ``load_state_dict``
takes a checkpoint as it is.  Public functions take and return NHWC,
the layout of the JAX package; convs inside a model run NCHW views.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

StateDict = Dict[str, torch.Tensor]


def prelu(x: torch.Tensor, weight: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """PReLU with a scalar or per-channel slope on axis ``dim``, computed
    in ``x``'s dtype: ``x`` where ``x >= 0``, else ``a * x`` rounded once."""
    a = weight.to(x.dtype)
    if a.numel() == 1 or dim == 1:
        return F.prelu(x, a)  # one pass; F.prelu takes its channels on axis 1
    shape = [1] * x.ndim
    shape[dim] = -1
    return torch.where(x >= 0, x, a.reshape(shape) * x)


def globalAvgPool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) on NCHW, averaged in fp32 -> (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)


def interleaveNested(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nested deferred layout -> spatial NHWC.

    x: (b, h, w, 2, 2, ..., 2, 2, c) with ``n`` (row, col) sub-position
    axis pairs appended in stage order (earlier stages outermost: fine
    row = ((a1*2 + a2)*2 + ...)).
    """
    b, h, w = x.shape[:3]
    c = x.shape[-1]
    rows = [3 + 2 * i for i in range(n)]
    cols = [4 + 2 * i for i in range(n)]
    y = x.permute(0, 1, *rows, 2, *cols, 3 + 2 * n)
    return y.reshape(b, h << n, w << n, c)


def packBlockDiag(sd: StateDict, pack: int = 3) -> StateDict:
    """Expand every conv weight to a block-diagonal over ``pack``
    independent copies (channels cin*pack -> cout*pack), torch layout.

    Channel-local ops (scalar PReLU slopes, per-channel pooling, sigmoid
    gates, residuals) are preserved exactly; biases tile per block.
    """
    out: StateDict = {}
    for k, v in sd.items():
        if v.ndim == 4 and k.endswith(".weight"):
            cout, cin, kh, kw = v.shape
            w = v.new_zeros((cout * pack, cin * pack, kh, kw))
            for p in range(pack):
                w[p * cout : (p + 1) * cout, p * cin : (p + 1) * cin] = v
            out[k] = w
        elif v.ndim == 1 and (k.endswith(".bias") or k.endswith(".scale")):
            out[k] = v.repeat(pack) if v.shape[0] > 1 or k.endswith(".bias") else v
        else:
            out[k] = v
    return out


def fromJaxParams(params: Dict[str, np.ndarray]) -> StateDict:
    """Inverse of the JAX package's ``convertStateDict`` for plain convs
    and linears: HWIO -> OIHW, (in, out) -> (out, in)."""
    out: StateDict = {}
    for k, v in params.items():
        v = np.asarray(v)
        if v.ndim == 4 and k.endswith("weight"):
            v = np.transpose(v, (3, 2, 0, 1))
        elif v.ndim == 2 and k.endswith("weight"):
            v = np.transpose(v)
        out[k] = torch.tensor(v)  # a copy: the source may be a read-only view
    return out


def loadTorchWeights(path: str) -> StateDict:
    """Load a checkpoint as a torch-layout state dict on the CPU.

    A ``.npz`` beside a ``.pth`` (written by the JAX package's converter,
    in its HWIO layout) is preferred, as the JAX loader prefers it.
    """
    npzPath = path[: -len(".pth")] + ".npz" if path.endswith(".pth") else path
    if npzPath.endswith(".npz") and os.path.exists(npzPath):
        with np.load(npzPath) as z:
            return fromJaxParams({k: z[k] for k in z.files})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "params" in sd and not torch.is_tensor(sd["params"]):
        sd = sd["params"]
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}
