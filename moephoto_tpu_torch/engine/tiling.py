"""Static halo-tile engine.

The image is reflect-padded so tiles of a fixed size on a fixed stride
cover it exactly; the tiles are run through the model in chunks of
``batch`` (the last chunk padded by repeating the last tile, so every
model call sees one shape), and the outputs are blended with a separable
sigmoid window by overlap-add and weight normalisation.

The overlap-add runs on an fp32 canvas whatever the model's dtype: a
canvas in bf16 would round every partial sum to 8 mantissa bits.  It
takes one chunk at a time (``ops/blend.py`` ``blendTiles``: one kernel
launch a chunk on the card, which copies nothing to it and never waits
for it; the per-tile loop on the CPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from moephoto_tpu_torch.ops.blend import blendTiles, blendWindow  # noqa: F401  (blendWindow: the engine's window)
from moephoto_tpu_torch.progress import count, span

ceilTo = lambda x, d: -(-int(x) // d) * d


@dataclass(frozen=True)
class TileSpec:
    """Static tiling parameters for one model.

    tile:   tile side length fed to the model (includes halos).
    pad:    halo width; adjacent tiles overlap by ``2 * pad`` pixels.
    align:  model stride alignment (tile and padded image are multiples).
    scale:  spatial scale factor of the model output.
    batch:  tiles evaluated per model call.
    """

    tile: int = 256
    pad: int = 8
    align: int = 8
    scale: float = 1.0
    batch: int = 8

    def __post_init__(self):
        if self.tile % self.align or self.tile <= 2 * self.pad:
            raise ValueError(f"bad tile spec {self}")


def planAxis(size: int, tile: int, pad: int) -> List[int]:
    """Static anchor positions along one axis: tiles of length ``tile``
    on stride ``tile - 2*pad`` starting at 0."""
    stride = tile - 2 * pad
    if size <= tile:
        return [0]
    n = math.ceil((size - 2 * pad) / stride)
    return [i * stride for i in range(n)]


def paddedExtent(size: int, tile: int, pad: int, align: int) -> int:
    if size <= tile:
        # single tile: pad only to alignment
        return ceilTo(size, align)
    anchors = planAxis(size, tile, pad)
    return max(anchors[-1] + tile, ceilTo(size, align))


def reflectPadHW(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad bottom/right of an (H, W, C) image, repeating the
    reflection when the pad exceeds the image extent."""
    y = x.permute(2, 0, 1)  # (C, H, W) for F.pad
    while ph > 0 or pw > 0:
        dh = min(ph, y.shape[1] - 1)
        dw = min(pw, y.shape[2] - 1)
        if dh == 0 and dw == 0:  # degenerate 1-pixel axis
            y = F.pad(y[None], (0, pw, 0, ph), mode="replicate")[0]
            break
        y = F.pad(y[None], (0, dw, 0, dh), mode="reflect")[0]
        ph -= dh
        pw -= dw
    return y.permute(1, 2, 0)


def _meshChunk(fn: Callable, tiles: List[torch.Tensor], batch: int, devices, home) -> torch.Tensor:
    """One chunk of up to ``batch * len(devices)`` tiles over a mesh: each
    device takes ``batch`` of them (the last padded by repeating its last
    tile, so every model call has the single-device shape) and the outputs
    come back to ``home``; a device with no tile of the chunk idles."""
    from moephoto_tpu_torch.parallel.sharded import stats

    outs = []
    for j, dev in enumerate(devices):
        sub = tiles[j * batch : (j + 1) * batch]
        if not sub:
            break
        n = len(sub)
        sub += sub[-1:] * (batch - n)
        outs.append(fn(torch.stack(sub).to(dev, non_blocking=True))[:n].to(home, non_blocking=True))
        stats["tileCalls"][j] = stats["tileCalls"].get(j, 0) + 1
    return torch.cat(outs)


def tiledApply(
    x: torch.Tensor, fn: Callable, spec: TileSpec, outC: int | None = None, mesh=None
) -> torch.Tensor:
    """Tiled application of a batched model ``fn`` to an (H, W, C) image.

    ``fn``: (B, th, tw, C) -> (B, th*scale, tw*scale, outC), on the device
    of its input.  Returns the blended (H*scale, W*scale, outC) image in
    fp32.  With a ``mesh`` (``parallel/mesh.py``) a chunk grows to ``batch``
    tiles per mesh device, as the JAX engine's ``_chunked`` shards its tile
    batch: tiles are independent halo-padded work, so this is exact data
    parallelism; the blend stays on ``x``'s device.
    """
    h, w, c = x.shape
    outC = outC or c
    tile, pad, align, sc = spec.tile, spec.pad, spec.align, spec.scale
    ph = paddedExtent(h, tile, pad, align)
    pw = paddedExtent(w, tile, pad, align)
    xp = reflectPadHW(x, ph - h, pw - w)

    # Anchors are planned on the image's own extent.  Planning them again
    # on the padded extent (as the JAX engine does) adds an anchor past
    # the end whenever alignment, not the last tile, sets the padded
    # extent (e.g. 50 px at tile 32, pad 5, align 8), and the tiles then
    # differ in size.  Where that does not happen the two plans agree.
    ys = planAxis(h, tile, pad)
    xs = planAxis(w, tile, pad)
    th, tw = min(tile, ph), min(tile, pw)
    oth, otw = int(round(th * sc)), int(round(tw * sc))
    padSc = int(round(pad * sc))
    oH, oW = int(round(ph * sc)), int(round(pw * sc))

    places: List[Tuple[int, int, Tuple[bool, ...]]] = [
        (y, xc, (iy == 0, iy == len(ys) - 1, ix == 0, ix == len(xs) - 1))
        for iy, y in enumerate(ys)
        for ix, xc in enumerate(xs)
    ]
    canvas = torch.zeros((oH, oW, outC), dtype=torch.float32, device=x.device)
    weight = torch.zeros((oH, oW, 1), dtype=torch.float32, device=x.device)
    n, batch = len(places), spec.batch
    devices = mesh.flat if mesh is not None else None
    per = batch * (len(devices) if devices else 1)
    for start in range(0, n, per):
        with span("moe.engine.chunk"):
            chunk = places[start : start + per]
            # every model call runs ``batch`` tiles: the last of a device's
            # share repeats to fill it
            count("tiles_needed", len(chunk))
            count("tiles_run", batch * -(-len(chunk) // batch))
            tiles = [xp[y : y + th, xc : xc + tw] for y, xc, _ in chunk]
            if devices:
                out = _meshChunk(fn, tiles, batch, devices, x.device)
            else:
                tiles += tiles[-1:] * (batch - len(chunk))  # one model shape per call
                out = fn(torch.stack(tiles))
            if out.shape[1:3] != (oth, otw):
                raise ValueError(f"tile output {tuple(out.shape)} != ({oth}, {otw})")
            blendTiles(canvas, weight, out, [(int(round(y * sc)), int(round(xc * sc))) for y, xc, _ in chunk],
                       [edges for _, _, edges in chunk], padSc)
    out = canvas / weight.clamp_min(1e-8)
    return out[: int(round(h * sc)), : int(round(w * sc))]
