"""Adaptive-interval 3D LUT transform (AiLUT, AdaInt CVPR 2022).

:func:`ailutTransform` replaces the Pallas kernel of the JAX package
(``moephoto_tpu/ops/lutkernel.py:185`` ``ailutTransformPallasT``) with a
CUDA kernel written for Hopper (``csrc/ailut.cu``).  The TPU kernel turns
the lookup into hat-weight matrix products because Mosaic cannot gather;
the card can, so the kernel runs the reference CUDA algorithm instead:
one thread per pixel, a lower-bound search of each channel value in its
sorted vertex row, then the 8-corner trilinear read of the LUT.  On a CPU
tensor the wrapper runs :func:`ailutTransformPlain`, which computes the
same function with the same fp32 operations in the same order.

:func:`ailutTransformClamped` replaces the JAX package's other AiLUT
kernel (``moephoto_tpu/ops/lutkernel.py:322`` ``ailutTransformPallas``,
body ``_lutKernel`` :58), which no model calls but the on-chip kernel
parity gate does (``tools/chipparity.py``): it clips r, g and b to one
range per image, lo = max of the three first vertices and hi = min of the
three last, as ``min(max(x, lo), hi)`` (so a NaN pixel stays NaN and
lo > hi gives hi), and then does exactly the lookup above.  Inside
[lo, hi] the two functions agree; outside, this one holds the edge value
where :func:`ailutTransform` extrapolates.  Same kernel source, its own
entry points, plain version (:func:`ailutTransformClampedPlain`) and
launch count.  On the card each launches through its registered op,
``moephoto_torch::ailut_transform`` and
``moephoto_torch::ailut_transform_clamped`` (``torch.library.custom_op``,
with fakes for tracing), so that a program exported with ``torch.export``
holds one node for the lookup and counts real launches only.  Vertices
are finite and strictly increasing: the TPU body divides by v[i] - v[i-1]
with no epsilon and gives NaN on equal neighbours, where this lookup
stays finite.

Semantics (the reference kernel and the JAX package's XLA transform):
bin = clip(#{v < x} - 1, 0, D - 2), fraction (x - v0) / (v1 - v0 + 1e-10)
left unclamped, so a value outside [v[0], v[D-1]] extrapolates linearly
from the edge cell.  ``lut[b, c, bid, gid, rid]`` is red-minor.

K6 (:func:`ailutTransformSpmd`) replaces ``moephoto_tpu/ops/lutkernel.py:271``
``ailutTransformPallasSpmd``: the transform per row shard, the LUT and
vertices copied to each shard's device; pointwise, so no halo.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from moephoto_tpu_torch.ops import _build
from moephoto_tpu_torch.parallel import sharded, temporal

SOURCE = "ailut.cu"
EPS = 1e-10
MAX_D = 64  # vertex rows the kernel keeps in shared memory


def ailutTransformPlain(img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Torch-op version of the kernel: (B, H, W, 3) -> (B, H, W, C).

    ``lut`` (B, C, D, D, D) red-minor, ``vertices`` (B, 3, D) sorted;
    computed in fp32, returned in ``img``'s dtype."""
    B, H, W, _ = img.shape
    C, D = lut.shape[1], lut.shape[-1]
    x = img.float().reshape(B, H * W, 3)
    vert = vertices.float()
    ids, fracs = [], []
    for ch in range(3):
        v = vert[:, ch]  # (B, D)
        val = x[..., ch]  # (B, N)
        cnt = (v[:, :, None] < val[:, None, :]).sum(dim=1)  # lower_bound
        i0 = (cnt - 1).clamp(0, D - 2)
        v0 = torch.gather(v, 1, i0)
        v1 = torch.gather(v, 1, i0 + 1)
        ids.append(i0)
        fracs.append((val - v0) / ((v1 - v0) + EPS))
    rid, gid, bid = ids
    rd, gd, bd = fracs
    flat = lut.float().reshape(B, C, D * D * D)
    base = rid + D * gid + D * D * bid  # (B, N)

    def corner(dr, dg, db):
        idx = (base + (dr + D * dg + D * D * db))[:, None, :].expand(B, C, -1)
        return torch.gather(flat, 2, idx)  # (B, C, N)

    ur, ug, ub = 1 - rd, 1 - gd, 1 - bd
    terms = (  # weight, corner; summed in this order
        ((ur * ug) * ub, corner(0, 0, 0)),
        ((rd * ug) * ub, corner(1, 0, 0)),
        ((ur * gd) * ub, corner(0, 1, 0)),
        ((rd * gd) * ub, corner(1, 1, 0)),
        ((ur * ug) * bd, corner(0, 0, 1)),
        ((rd * ug) * bd, corner(1, 0, 1)),
        ((ur * gd) * bd, corner(0, 1, 1)),
        ((rd * gd) * bd, corner(1, 1, 1)),
    )
    out = None
    for w, c in terms:
        t = w[:, None, :] * c
        out = t if out is None else out + t
    return out.permute(0, 2, 1).reshape(B, H, W, C).to(img.dtype)


def clampRange(vertices: torch.Tensor):
    """Per image the range all three channels share: lo = max of the first
    vertices, hi = min of the last, each (B,) fp32."""
    v = vertices.float()
    return v[:, :, 0].max(dim=1).values, v[:, :, -1].min(dim=1).values


def ailutTransformClampedPlain(img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Torch-op version of the clamping kernel: the image clipped in fp32
    to :func:`clampRange` as min(max(x, lo), hi), then
    :func:`ailutTransformPlain`; returned in ``img``'s dtype."""
    lo, hi = (t.reshape(-1, 1, 1, 1) for t in clampRange(vertices))
    x = torch.minimum(torch.maximum(img.float(), lo), hi)
    return ailutTransformPlain(x, lut, vertices).to(img.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.ailutTransformF32, lib.ailutTransformBF16,
                   lib.ailutTransformClampedF32, lib.ailutTransformClampedBF16):
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.ailutErrorString.argtypes = [ctypes.c_int]
        lib.ailutErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _onCard(name: str, img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Check the tensors and launch the entry point ``name`` + F32/BF16
    through its registered op (``moephoto_torch::ailut_transform`` or
    ``moephoto_torch::ailut_transform_clamped``); raises on anything the
    kernel does not take.  The checks read only shapes, types and devices,
    so they run as they are under ``torch.export``, where the call becomes
    one node of the op."""
    tensors = (img, lut, vertices)
    if not (img.is_cuda and lut.device == img.device and vertices.device == img.device):
        raise ValueError(f"{name}: img on {img.device}, lut on {lut.device}, "
                         f"vertices on {vertices.device}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes an fp32 or bf16 image, got {img.dtype}")
    if lut.dtype != torch.float32 or vertices.dtype != torch.float32:
        raise TypeError(f"{name} takes an fp32 lut and vertices, got {lut.dtype}/{vertices.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"{name}: image shape {tuple(img.shape)}, want (B, H, W, 3)")
    B = img.shape[0]
    D = lut.shape[-1]
    if lut.shape != (B, 3, D, D, D) or vertices.shape != (B, 3, D):
        raise ValueError(f"{name}: lut {tuple(lut.shape)}, vertices {tuple(vertices.shape)} "
                         f"for a batch of {B}")
    if not 2 <= D <= MAX_D:
        raise ValueError(f"{name}: D={D} not in 2..{MAX_D}")
    return _OPS[name](img, lut, vertices)


def _launch(wrapper, img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """The launch behind the op of ``wrapper`` (entry point
    ``wrapper.__name__`` + F32/BF16), on tensors :func:`_onCard` checked;
    counts the launch on ``wrapper``."""
    name = wrapper.__name__
    B, H, W, _ = img.shape
    D = lut.shape[-1]
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    # channel-last, padded to 4: each corner is one aligned 16-byte read
    lut4 = F.pad(lut.permute(0, 2, 3, 4, 1), (0, 1)).contiguous()
    lib = _library()
    fn = getattr(lib, name + ("BF16" if img.dtype == torch.bfloat16 else "F32"))
    with torch.cuda.device(img.device):  # the launch goes to the tensors' card, on its stream
        err = fn(img.data_ptr(), lut4.data_ptr(), vertices.data_ptr(), out.data_ptr(), H * W, D, B,
                 torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.ailutErrorString(err).decode()}")
    wrapper.launches += 1
    return out


def _allOnCpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def ailutTransform(img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Apply an adaptive 3D LUT: (B, H, W, 3) -> (B, H, W, 3).

    ``img`` fp32 or bf16, ``lut`` (B, 3, D, D, D) and ``vertices``
    (B, 3, D) fp32, all contiguous.  CPU tensors take
    :func:`ailutTransformPlain`; CUDA tensors launch the kernel or raise.
    """
    if _allOnCpu(img, lut, vertices):
        return ailutTransformPlain(img, lut, vertices)
    return _onCard("ailutTransform", img, lut, vertices)


ailutTransform.launches = 0


def ailutTransformClamped(img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Apply an adaptive 3D LUT to the image clipped to the vertex range
    all channels share: shapes and types as :func:`ailutTransform`.  CPU
    tensors take :func:`ailutTransformClampedPlain`; CUDA tensors launch
    the kernel or raise."""
    if _allOnCpu(img, lut, vertices):
        return ailutTransformClampedPlain(img, lut, vertices)
    return _onCard("ailutTransformClamped", img, lut, vertices)


ailutTransformClamped.launches = 0


def _registerOp(wrapper, opName: str):
    """``moephoto_torch::<opName>``: the launch of ``wrapper``'s entry point
    as an op for the card, with a fake that gives the image's shape and dtype."""

    @torch.library.custom_op(f"moephoto_torch::{opName}", mutates_args=(), device_types="cuda")
    def op(img: torch.Tensor, lut: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
        return _launch(wrapper, img, lut, vertices)

    @op.register_fake
    def _(img, lut, vertices):
        return torch.empty_like(img)

    return op


_OPS = {f.__name__: _registerOp(f, op) for f, op in ((ailutTransform, "ailut_transform"),
                                                     (ailutTransformClamped, "ailut_transform_clamped"))}


def ailutTransformSpmd(img, lut: torch.Tensor, vertices: torch.Tensor):
    """:func:`ailutTransform` row-sharded (K6, the port of
    ``moephoto_tpu/ops/lutkernel.py:271`` ``ailutTransformPallasSpmd``):
    ``img`` as RowShards on axis 1 (or a whole tensor, then cut over the
    video mesh and the result gathered).  The transform is pointwise, so
    there is no halo: the LUT and vertices are copied once to each shard's
    device and the kernel (or its plain version on a CPU shard) runs shard
    by shard, bit-equal to the single-device transform by construction."""
    whole = not isinstance(img, sharded.RowShards)
    if whole:
        mesh = temporal.videoMesh()
        if mesh is None:
            return ailutTransform(img, lut, vertices)
        img = sharded.RowShards.split(img, mesh.flat, 1)
    if img.axis != 1:
        raise ValueError(f"ailutTransformSpmd: rows on axis {img.axis}, want 1")
    tables, outs = {}, []
    for part in img.parts:
        dev = part.device
        if dev not in tables:
            tables[dev] = (lut.to(dev), vertices.to(dev))
        out = ailutTransform(part.contiguous(), *tables[dev])
        if out.is_cuda and out.numel():
            ailutTransformSpmd.launches += 1
        outs.append(out)
    res = sharded.RowShards(outs, img.bounds, 1)
    return res.gather() if whole else res


ailutTransformSpmd.launches = 0
