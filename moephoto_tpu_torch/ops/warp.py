"""Bilinear warping by a pixel-offset flow (K2).

:func:`warp` replaces the Pallas kernel of the JAX package
(``moephoto_tpu/ops/warp.py:170`` ``_warpPallas``, reached through
``warpBounded`` :322) with a CUDA kernel written for Hopper
(``csrc/warp.cu``).  The TPU kernel tiles the output, keeps a slab of the
image with a margin of M pixels in VMEM and gathers along the 128-lane
axis only, so it needs |flow| < M - 1 and falls back to XLA's gather
beyond 15 px; the card gathers from anywhere, so the kernel computes the
function itself for any flow, with no tiers.  On a CPU tensor the wrapper
runs :func:`warpPlain`, which computes the same function with the same
fp32 operations in the same order.

Semantics (JAX ``warpXLAExact`` :212 through ``gridSample`` :16): sample
``img[b]`` bilinearly at (x + u, y + v) with u, v = ``flow[b, y, x]``;
``border`` clamps each tap to the image, ``zeros`` reads zero outside it.
Coordinates and weights are fp32, the blend is fp32, and the result is
rounded once to the image's dtype.

K2a (:func:`warpSpmd`, :func:`backWarpSpmd`) replaces the JAX package's
row-sharded wrappers (``warpBoundedSpmd`` :264, ``backWarpBoundedSpmd``
:227), which run the Pallas tiers per shard inside ``shard_map`` after a
halo exchange of the tier's margin: here the port's own kernel runs per row
shard (``parallel/sharded.py``) with a halo of the flow's global row reach,
and K2 takes the shard's row offset and the global height, so each row is
bit-equal to the single-device warp.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from moephoto_tpu_torch.ops import _build
from moephoto_tpu_torch.parallel import sharded

SOURCE = "warp.cu"
MAX_C = 256
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"border": 0, "zeros": 1}


def _coords(s: torch.Tensor, n: int):
    """Tap indices and weight of an fp32 coordinate along an axis of size
    ``n``: indices from the coordinate clamped to [-2, n + 1] (NaN to -2),
    so every tap of a huge or non-finite coordinate lies outside the image
    in both modes; the weight from the unclamped coordinate."""
    w = s - torch.floor(s)
    c = torch.nan_to_num(s, nan=-2.0, posinf=n + 1.0, neginf=-2.0).clamp(-2.0, n + 1.0)
    i0 = torch.floor(c).long()
    return i0, i0 + 1, w


def warpPlain(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border",
              rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Torch-op version of the kernel: (B, H, W, C), flow (B, H, W, 2) ->
    (B, H, W, C) in ``img``'s dtype.

    ``rows = (out0, img0, full)`` warps a row window (K2a): the flow and
    the output are the global rows [out0, out0 + H) of an image of ``full``
    rows, ``img`` holds its rows [img0, img0 + img.shape[1]); coordinates,
    the border clamp and the zeros test are the global image's, a tap row
    is then clamped into ``img``."""
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode {padding_mode!r} not in {tuple(_MODES)}")
    B, H, W, C = flow.shape[:3] + img.shape[3:]
    Hi = img.shape[1]
    out0, img0, full = rows if rows is not None else (0, 0, Hi)
    dev = img.device
    sx = torch.arange(W, dtype=torch.float32, device=dev) + flow[..., 0].float()
    sy = torch.arange(out0, out0 + H, dtype=torch.float32, device=dev)[:, None] + flow[..., 1].float()
    x0, x1, wx = _coords(sx, W)
    y0, y1, wy = _coords(sy, full)
    table = img.reshape(B, Hi * W, C)

    def tap(yi, xi):
        yw = (yi.clamp(0, full - 1) - img0).clamp(0, Hi - 1)
        idx = (yw * W + xi.clamp(0, W - 1)).reshape(B, H * W, 1).expand(B, H * W, C)
        v = torch.gather(table, 1, idx).float().reshape(B, H, W, C)
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= full - 1) & (xi >= 0) & (xi <= W - 1)
            v = torch.where(inside[..., None], v, torch.zeros((), device=dev))
        return v

    wx, wy = wx[..., None], wy[..., None]
    ux, uy = 1 - wx, 1 - wy
    top = tap(y0, x0) * ux + tap(y0, x1) * wx
    bot = tap(y1, x0) * ux + tap(y1, x1) * wx
    return (top * uy + bot * wy).to(img.dtype)


def backWarpFlow(flow: torch.Tensor, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Fold ``backWarp``'s normalisation quirk into a pixel-offset flow.

    ``backWarp`` (reference videoSR.py:43-72) normalises grid + flow by W
    and denormalises by W - 1 (align_corners), so it samples at
    (x + u)(W - 1)/W, not x + u: with u' = u(W - 1)/W - x/W, exact warping
    by u' is ``backWarp`` by u (JAX ``backWarpBounded``, warp.py:243).
    ``rows = (row0, full)``: ``flow`` is the global rows [row0, row0 + H)
    of a flow of ``full`` rows, folded on global row coordinates."""
    B, H, W, _ = flow.shape
    row0, full = rows if rows is not None else (0, H)
    dev = flow.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(row0, row0 + H, dtype=torch.float32, device=dev)
    u, v = flow[..., 0].float(), flow[..., 1].float()
    up = u * ((W - 1.0) / W) - xs[None, None, :] * (1.0 / W)
    vp = v * ((full - 1.0) / full) - ys[None, :, None] * (1.0 / full)
    return torch.stack([up, vp], dim=-1)


def backWarp(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """``backWarp`` semantics through :func:`warp` (the single-device part
    of K2a, JAX ``backWarpBounded``)."""
    return warp(img, backWarpFlow(flow), padding_mode)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        lib.warpBilinear.argtypes = ([ctypes.c_int, ctypes.c_int, ptr, i64, i64, i64, ptr, i64, i64, i64, ptr]
                                     + [ctypes.c_int] * 9 + [ptr])
        lib.warpBilinear.restype = ctypes.c_int
        lib.warpErrorString.argtypes = [ctypes.c_int]
        lib.warpErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _unitChannel(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis has unit stride (any batch, row and
    pixel strides, e.g. a batch broadcast by ``expand``), else a
    contiguous copy."""
    return t if t.shape[-1] == 1 or t.stride(-1) == 1 else t.contiguous()


def warp(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border",
         rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Bilinear warp at (x + u, y + v): (B, H, W, C) -> (B, H, W, C).

    ``img`` fp32 or bf16 with 1 <= C <= 256, ``flow`` (B, H, W, 2) fp32 or
    bf16; any batch, row and pixel strides.  ``rows = (out0, img0, full)``
    warps a row window, as :func:`warpPlain` says.  CPU tensors take
    :func:`warpPlain`; CUDA tensors launch the kernel or raise.
    """
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warpPlain(img, flow, padding_mode, rows)
    if not (img.is_cuda and flow.device == img.device):
        raise ValueError(f"warp: img on {img.device}, flow on {flow.device}")
    if img.dtype not in _TYPES or flow.dtype not in _TYPES:
        raise TypeError(f"warp takes fp32 or bf16 tensors, got {img.dtype}/{flow.dtype}")
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode {padding_mode!r} not in {tuple(_MODES)}")
    B, H, W, C = flow.shape[:3] + img.shape[3:]
    out0, img0, full = rows if rows is not None else (0, 0, H)
    if (img.ndim != 4 or flow.shape[3] != 2 or img.shape[0] != B or img.shape[2] != W
            or not (0 <= out0 and out0 + H <= full and 0 <= img0 and img0 + img.shape[1] <= full)
            or (rows is None and img.shape[1] != H)):
        raise ValueError(f"warp: image {tuple(img.shape)}, flow {tuple(flow.shape)}, rows {rows}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"warp: C={C} not in 1..{MAX_C}")
    out = torch.empty((B, H, W, C), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    img, flow = _unitChannel(img), _unitChannel(flow)
    lib = _library()
    with torch.cuda.device(img.device):  # the launch goes to the tensors' card, on its stream
        err = lib.warpBilinear(_TYPES[img.dtype], _TYPES[flow.dtype], img.data_ptr(), *img.stride()[:3],
                               flow.data_ptr(), *flow.stride()[:3], out.data_ptr(), B, H, W, C,
                               out0, img0, img.shape[1], full,
                               _MODES[padding_mode], torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp launch failed: {lib.warpErrorString(err).decode()}")
    warp.launches += 1
    return out


warp.launches = 0


def rowReach(parts: Sequence[torch.Tensor], channels) -> int:
    """ceil of the largest finite |value| of ``channels`` (of the last
    axis) over every part, combined across the parts' devices and read to
    the host once (counted in ``sharded.stats["hostReads"]``).  A
    non-finite value does not size it: the kernels send a NaN or infinite
    coordinate's taps outside the image, and its weight makes the result
    NaN, whatever row is read."""
    if any(p.device.type not in ("cpu", "cuda") for p in parts):
        raise ValueError(f"row shards on {[p.device for p in parts]}: the sharded ops take CPU or CUDA shards")
    home = parts[0].device
    maxes = []
    for p in parts:
        v = p[..., channels].float().abs()
        maxes.append(torch.where(torch.isfinite(v), v, torch.zeros((), device=v.device)).amax().to(home))
    sharded.stats["hostReads"] += 1
    return int(math.ceil(float(torch.stack(maxes).amax())))


def _checkShards(img: sharded.RowShards, flow: sharded.RowShards, what: str) -> None:
    """Image and flow shards on row axis 1, with the same bounds and devices."""
    if img.axis != 1 or flow.axis != 1 or img.bounds != flow.bounds:
        raise ValueError(f"{what}: image rows {img.bounds} on axis {img.axis}, flow {flow.bounds} on {flow.axis}")
    if img.devices != flow.devices:
        raise ValueError(f"{what}: image shards on {img.devices}, flow shards on {flow.devices}")


def warpSpmd(img: sharded.RowShards, flow: sharded.RowShards, padding_mode: str = "border",
             reach: Optional[int] = None) -> sharded.RowShards:
    """:func:`warp` row-sharded (K2a, the port of ``moephoto_tpu/ops/warp.py:264``
    ``warpBoundedSpmd``): ``img`` and ``flow`` as RowShards on axis 1 with
    the same bounds.  The halo is the flow's global row reach,
    ceil(max |v|) + 1, read once; each shard's image window takes rows from
    as many shards as that spans, and the kernel (or its plain version on a
    CPU shard) warps the shard's rows at their global coordinates, so each
    output row is bit-equal to the single-device :func:`warp`'s.  A caller
    that warps by several flows may pass ``reach``, a :func:`rowReach` of
    them all, read once for all of them."""
    _checkShards(img, flow, "warpSpmd")
    reach = (rowReach(flow.parts, 1) if reach is None else reach) + 1
    H, outs = img.rows, []
    for j in range(img.n):
        a, b = img.rowsOf(j)
        lo, hi = max(0, a - reach), min(H, b + reach)
        out = warp(img.window(j, lo, hi), flow.parts[j], padding_mode, (a, lo, H))
        if out.is_cuda:
            warpSpmd.launches += 1
        outs.append(out)
    return sharded.RowShards(outs, img.bounds, 1)


warpSpmd.launches = 0


def backWarpSpmd(img: sharded.RowShards, flow: sharded.RowShards, padding_mode: str = "border",
                 reach: Optional[int] = None) -> sharded.RowShards:
    """``backWarp`` row-sharded (the port of ``backWarpBoundedSpmd``,
    ``moephoto_tpu/ops/warp.py:227``): the normalisation fold on global row
    coordinates shard by shard, then :func:`warpSpmd`.  A caller that warps
    by several flows may pass ``reach``, a :func:`rowReach` of the flows as
    given (unfolded), read once for all of them: the fold moves a sample
    by less than one row, so the halo takes one row more."""
    _checkShards(img, flow, "backWarpSpmd")
    folded = sharded.RowShards([backWarpFlow(p, (a, flow.rows)) for p, a in zip(flow.parts, flow.bounds)],
                               flow.bounds, 1)
    return warpSpmd(img, folded, padding_mode, None if reach is None else reach + 1)
