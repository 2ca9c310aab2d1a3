"""Overlap-add of a chunk of tile outputs into the engine's canvas (K7).

:func:`blendTiles` adds a chunk of tiles, each times its separable sigmoid
window (:func:`blendWindow`), into the fp32 canvas and the window into the
weight, as ``engine/tiling.py`` ``tiledApply`` blends them.  It replaces
no TPU kernel: the JAX engine's overlap-add is a ``lax.scan``
(``moephoto_tpu/engine/tiling.py:246-258``) that XLA fuses.  On the card
one launch of ``csrc/blend.cu`` takes the whole chunk; the kernel derives
the windows by :func:`axisWindow`'s rule from one ramp table
(:func:`rampOn`, copied to the card once per ``padSc`` and kept for the
process) and each tile's edge flags, which go with its origin into the
launch's parameters, so a chunk copies nothing to the card and never
waits for it.  On CPU tensors the wrapper runs :func:`blendTilesPlain`,
the per-tile loop, which adds the same rounded terms in the same order:
the kernel's canvas and weight are bit-equal to it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from moephoto_tpu_torch.ops import _build
from moephoto_tpu_torch.progress import count

SOURCE = "blend.cu"
MAX_TILES = 256  # csrc/blend.cu kMaxTiles: a larger chunk takes several launches, in order
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
FIRST_Y, LAST_Y, FIRST_X, LAST_X = 1, 2, 4, 8

Edges = Tuple[bool, bool, bool, bool]  # (firstY, lastY, firstX, lastX): the tile's sides on the image's border

_tables: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def ramp(n: int) -> torch.Tensor:
    """Sigmoid ramp over ``n`` pixels, on the CPU; half-pixel centering
    makes ramp[i] + ramp[n-1-i] == 1, a partition of unity across an
    overlap."""
    t = ((torch.arange(n, dtype=torch.float32) + 0.5) / n - 0.5) * 9.0
    return torch.sigmoid(t)


def rampSpan(padSc: int) -> Tuple[int, int]:
    """(d, r) of an interior edge: the outermost ``d`` pixels weigh 0 and
    the ramp runs over the next ``r``."""
    d = padSc // 2
    return d, 2 * (padSc - d)


def axisWindow(t: int, padSc: int, isFirst: bool, isLast: bool) -> torch.Tensor:
    """1D blend weights for one tile along one axis, on the CPU: interior
    edges drop the outermost ``padSc//2`` pixels and ramp across the
    central ``2*(padSc - d)`` pixels of the overlap; image-boundary edges
    keep weight 1 to the end.  The last side is assigned after the first,
    so it wins where they meet; ``csrc/blend.cu`` follows the same rule
    pixel by pixel."""
    w = torch.ones(t)
    if padSc == 0:
        return w
    d, r = rampSpan(padSc)
    table = ramp(r)
    if not isFirst:
        w[:d] = 0.0
        w[d : d + r] = table
    if not isLast:
        w[t - d :] = 0.0
        w[t - d - r : t - d] = table.flip(0)
    return w


def blendWindow(th: int, tw: int, padSc: int, edges=(False, False, False, False),
                device=None) -> torch.Tensor:
    """2D separable fp32 blend window; ``edges`` = (firstY, lastY,
    firstX, lastX) flags marking image-boundary sides.  The product is
    formed on ``device``, so only the two 1D windows are copied there."""
    wy = axisWindow(th, padSc, edges[0], edges[1]).to(device)
    wx = axisWindow(tw, padSc, edges[2], edges[3]).to(device)
    return wy[:, None] * wx[None, :]


def rampOn(padSc: int, device) -> torch.Tensor:
    """The ramp table of ``padSc`` (> 0) on ``device``, for the kernel:
    made on the CPU by :func:`ramp` and copied there on first use, then
    kept for the process.  Each copy records ``moe.count.blend_uploads=1``
    (while the profiler records); a table already there records nothing."""
    key = (padSc, torch.device(device))
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = ramp(rampSpan(padSc)[1]).to(key[1])
        count("blend_uploads", 1)
    return table


def _check(canvas, weight, tiles, origins, edges, padSc) -> None:
    H, W, C = canvas.shape
    if canvas.dtype != torch.float32 or weight.dtype != torch.float32 or tuple(weight.shape) != (H, W, 1):
        raise ValueError(f"blendTiles: canvas {canvas.dtype}{tuple(canvas.shape)}, weight "
                         f"{weight.dtype}{tuple(weight.shape)}; both fp32, the weight (H, W, 1)")
    if tiles.ndim != 4 or tiles.shape[3] != C or len(origins) != len(edges) or len(origins) > tiles.shape[0]:
        raise ValueError(f"blendTiles: tiles {tuple(tiles.shape)} for {len(origins)} origins and {len(edges)} "
                         f"edge sets on a canvas of {C} channels")
    th, tw = tiles.shape[1:3]
    for oy, ox in origins:
        if not (0 <= oy and oy + th <= H and 0 <= ox and ox + tw <= W):
            raise ValueError(f"blendTiles: a ({th}, {tw}) tile at ({oy}, {ox}) leaves the ({H}, {W}) canvas")
    if padSc < 0:
        raise ValueError(f"blendTiles: padSc={padSc}")
    d, r = rampSpan(padSc)
    for axis, t in ((0, th), (1, tw)):  # an interior edge's zeros and ramp fit in the tile
        if padSc and t < d + r and any(not e[2 * axis] or not e[2 * axis + 1] for e in edges):
            raise ValueError(f"blendTiles: a {t}-pixel tile axis is shorter than its edge's {d + r} pixels")


def blendTilesPlain(canvas: torch.Tensor, weight: torch.Tensor, tiles: torch.Tensor,
                    origins: Sequence[Tuple[int, int]], edges: Sequence[Edges], padSc: int) -> None:
    """Torch-op version of the kernel, in place: tile ``k`` of ``tiles``
    (n, th, tw, C) times its window into ``canvas[oy:oy+th, ox:ox+tw]``
    and the window into ``weight``, tile after tile, for the first
    ``len(origins)`` tiles (the rest, a padded chunk's repeats, are not
    blended).  Windows come from :func:`blendWindow`, one per edge set."""
    _check(canvas, weight, tiles, origins, edges, padSc)
    th, tw = tiles.shape[1:3]
    windows: Dict[Edges, torch.Tensor] = {}
    for (oy, ox), e, tile in zip(origins, edges, tiles):
        if e not in windows:
            windows[e] = blendWindow(th, tw, padSc, e, canvas.device)[:, :, None]
        win = windows[e]
        canvas[oy : oy + th, ox : ox + tw] += tile.float() * win
        weight[oy : oy + th, ox : ox + tw] += win


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.blendTiles.argtypes = ([i32, ptr, i64, i64, i64, i64, ptr, ptr] + [i32] * 5
                                   + [ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_ubyte), i32, ptr, i32, ptr])
        lib.blendTiles.restype = i32
        lib.blendErrorString.argtypes = [i32]
        lib.blendErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def blendTiles(canvas: torch.Tensor, weight: torch.Tensor, tiles: torch.Tensor,
               origins: Sequence[Tuple[int, int]], edges: Sequence[Edges], padSc: int) -> None:
    """Blend a chunk of tiles into ``canvas`` (H, W, C) and ``weight``
    (H, W, 1), both contiguous fp32, in place: ``tiles`` (n, th, tw, C) in
    fp32 or bf16 with any strides, ``origins`` the canvas (oy, ox) and
    ``edges`` the (firstY, lastY, firstX, lastX) flags of its first
    ``len(origins)`` tiles, ``padSc`` the halo at the output's scale.  CPU
    tensors take :func:`blendTilesPlain`; CUDA tensors launch the kernel,
    one launch for up to :data:`MAX_TILES` tiles, or raise."""
    if canvas.device.type == "cpu" and weight.device.type == "cpu" and tiles.device.type == "cpu":
        return blendTilesPlain(canvas, weight, tiles, origins, edges, padSc)
    if not (canvas.is_cuda and weight.device == canvas.device and tiles.device == canvas.device):
        raise ValueError(f"blendTiles: canvas on {canvas.device}, weight on {weight.device}, tiles on {tiles.device}")
    if tiles.dtype not in _TYPES:
        raise TypeError(f"blendTiles takes fp32 or bf16 tiles, got {tiles.dtype}")
    if not (canvas.is_contiguous() and weight.is_contiguous()):
        raise ValueError("blendTiles takes a contiguous canvas and weight")
    _check(canvas, weight, tiles, origins, edges, padSc)
    if not origins:
        return
    H, W, C = canvas.shape
    th, tw = tiles.shape[1:3]
    table = rampOn(padSc, canvas.device) if padSc else None
    lib = _library()
    sb = tiles.stride(0)
    with torch.cuda.device(canvas.device):  # the launch goes to the tensors' card, on its stream
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        for g in range(0, len(origins), MAX_TILES):
            part = range(g, min(g + MAX_TILES, len(origins)))
            flat = (ctypes.c_int * (2 * len(part)))(*(v for k in part for v in origins[k]))
            flags = (ctypes.c_ubyte * len(part))(*(
                FIRST_Y * e[0] | LAST_Y * e[1] | FIRST_X * e[2] | LAST_X * e[3] for e in (edges[k] for k in part)))
            err = lib.blendTiles(_TYPES[tiles.dtype], tiles.data_ptr() + g * sb * tiles.element_size(), sb,
                                 *tiles.stride()[1:], canvas.data_ptr(), weight.data_ptr(), H, W, C, th, tw,
                                 flat, flags, len(part), table.data_ptr() if table is not None else None, padSc,
                                 stream)
            if err != 0:
                raise RuntimeError(f"blendTiles launch failed: {lib.blendErrorString(err).decode()}")
            blendTiles.launches += 1


blendTiles.launches = 0
