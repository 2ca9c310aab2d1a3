"""Layer primitives and weight loading.

Parameters stay in torch layout (Conv2d OIHW, Linear (out, in)) under
the checkpoint's state-dict keys, so a module's ``load_state_dict``
takes a checkpoint as it is.  Public functions take and return NHWC,
the layout of the JAX package; convs inside a model run NCHW views.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

StateDict = Dict[str, torch.Tensor]
# (key, torch shape) -> bool: selects the ConvTranspose2d weights
ConvTPredicate = Optional[Callable[[str, Tuple[int, ...]], bool]]


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


def resizeBilinear(x: torch.Tensor, h: int, w: int, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC to (h, w), no antialiasing when shrinking,
    as the JAX package's resize: half-pixel centres with edge clamp, or
    corner-aligned with ``align_corners``.  The exact 2x upsample, which
    the JAX package writes as phase adds (``resizeBilinear2x``), is this
    resize at (2h, 2w)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=align_corners, antialias=False)
    return y.permute(0, 2, 3, 1)


def resizeNearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of NHWC to (h, w), sampling at half-pixel centres as
    ``jax.image.resize(method="nearest")``: source index
    floor((i + 0.5) * in / out), in fp32.  (``F.interpolate``'s ``nearest``
    samples at floor(i * in / out), another pixel at non-integer ratios.)"""
    for dim, n in ((-3, h), (-2, w)):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).floor().long()
            x = x.index_select(dim % x.ndim, idx.clamp_(max=m - 1))
    return x


def cubicWeights(inSize: int, outSize: int, device=None) -> torch.Tensor:
    """(inSize, outSize) fp32 weights of ``jax.image.resize``'s ``cubic``
    along one axis: the Keys kernel (a = -0.5) at half-pixel centres,
    widened by in/out when shrinking (antialiasing, JAX's default), each
    output's weights divided by their sum, so the border renormalises
    instead of replicating the edge pixel."""
    f32 = torch.float32
    inv = 1.0 / torch.tensor(outSize / inSize, dtype=f32, device=device)
    sample = (torch.arange(outSize, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(inSize, dtype=f32, device=device)[:, None]).abs() / inv.clamp_min(1.0)
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros((), device=device), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps, w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= inSize - 0.5))[None, :], w, 0.0)


def resizeCubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Cubic resize of NHWC to (h, w) as ``jax.image.resize(x, shape,
    "cubic")``: two separable fp32 weight matrices (:func:`cubicWeights`),
    an axis of unchanged size left alone.  (``F.interpolate``'s ``bicubic``
    has a = -0.75 and replicates the border.)"""
    y = x.float()
    if y.shape[-3] != h:
        y = torch.einsum("...hwc,hk->...kwc", y, cubicWeights(y.shape[-3], h, x.device))
    if y.shape[-2] != w:
        y = torch.einsum("...hwc,wk->...hkc", y, cubicWeights(y.shape[-2], w, x.device))
    return y.to(x.dtype)


class ScaleLayer(torch.nn.Module):
    """Learned scalar multiplier (key ``scale``; reference ``ScaleLayer``)."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def leakyRelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


sigmoid = torch.sigmoid


def conv(layer: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv layer on an NHWC tensor, run on its NCHW view -> NHWC."""
    return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def pixelShuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Torch pixel_shuffle on NHWC: channel index c r^2 + i r + j."""
    b, h, w, c = x.shape
    co = c // (r * r)
    y = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)  # b, h, i, w, j, co
    return y.reshape(b, h * r, w * r, co)


def avgPool2d(x: torch.Tensor, k: int, stride: int, padding: int = 0,
              count_include_pad: bool = True) -> torch.Tensor:
    """Average pool on NHWC, summed in fp32 and rounded once."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), k, stride, padding, count_include_pad=count_include_pad)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def maxPool2d(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool on NHWC; the padding counts as -inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding).permute(0, 2, 3, 1)


@contextlib.contextmanager
def fullFp32():
    """fp32 convolutions and matrix products in full fp32 inside the block,
    whatever the process-wide TF32 flags say; the flags are restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def fromJaxParams(params: Dict[str, np.ndarray], convT: ConvTPredicate = None) -> StateDict:
    """Inverse of the JAX package's ``convertStateDict(sd, convT)``.

    Conv weights go HWIO -> OIHW and linears (in, out) -> (out, in).  A
    weight that ``convT`` selects was a ConvTranspose2d: JAX stored it as
    the equivalent direct conv (IOHW spatially flipped, then HWIO), so it
    goes back by the transpose (2, 3, 0, 1) and a flip of both spatial
    axes.  The predicate sees the torch shape (I, O, kH, kW) read as a
    ConvTranspose weight, as ``convertStateDict`` shows it the torch shape.
    """
    out: StateDict = {}
    for k, v in params.items():
        v = np.asarray(v)
        if v.ndim == 4 and k.endswith("weight"):
            asConvT = np.transpose(v, (2, 3, 0, 1))  # HWIO -> I O H W
            if convT is not None and convT(k, asConvT.shape):
                v = asConvT[:, :, ::-1, ::-1]
            else:
                v = np.transpose(v, (3, 2, 0, 1))
        elif v.ndim == 2 and k.endswith("weight"):
            v = np.transpose(v)
        out[k] = torch.tensor(np.ascontiguousarray(v))  # a copy: the source may be a read-only view
    return out


def loadTorchWeights(path: str, convT: ConvTPredicate = None) -> StateDict:
    """Load a checkpoint as a torch-layout state dict on the CPU.

    A ``.npz`` beside a ``.pth`` (written by the JAX package's converter,
    in its layout) is preferred, as the JAX loader prefers it; ``convT``
    names its ConvTranspose weights, as for the JAX loader.
    """
    npzPath = path[: -len(".pth")] + ".npz" if path.endswith(".pth") else path
    if npzPath.endswith(".npz") and os.path.exists(npzPath):
        with np.load(npzPath) as z:
            return fromJaxParams({k: z[k] for k in z.files}, convT)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "params" in sd and not torch.is_tensor(sd["params"]):
        sd = sd["params"]
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}
