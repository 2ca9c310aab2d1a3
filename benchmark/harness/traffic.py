"""The one traffic generator: a mix file's parameters and a seed -> the
requests of a run.

Two kinds of mix, named by the file's ``kind``:

``images``: a pool of ``pool`` RGB photos (uint8 HWC arrays, as a decoder
gives them), sent one after another in a closed loop: request ``i`` is
pool image ``order[i % pool]``.  Sizes are ``sizes`` ([width, height],
cycled over the pool), or drawn once from the mix's own ``shape_seed``:
the long side uniform over ``long_side`` = [low, high, step], the aspect
from ``aspects``, portrait with odds ``portrait``.  So every seed sends
the same set of sizes; the seed draws the content and the order.

``clip``: ``frames`` frames of ``width`` x ``height`` as 16-bit BGR raw
bytes (the decoder pipe's bgr48le), fed in order and looped: a textured
background panning by a whole number of pixels a frame and a textured
patch moving at another velocity, both at most ``max_speed`` pixels a
frame along each axis.  The loop point is a scene cut.

Pictures are made on the device from the seed: smooth colour fields at
two scales, fine grain, and rectangles with hard edges.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def picture(g: torch.Generator, h: int, w: int, device, rects: int = 12) -> torch.Tensor:
    """(3, h, w) fp32 in [0, 1]."""
    rand = lambda *s: torch.rand(*s, generator=g, device=device)

    def field(ch, cw, mode):
        return F.interpolate(rand(1, 3, ch, cw), size=(h, w), mode=mode, align_corners=False)[0]

    img = (0.55 * field(max(2, h // 96), max(2, w // 96), "bicubic")
           + 0.30 * field(h // 12 + 2, w // 12 + 2, "bilinear") + 0.15 * rand(3, h, w))
    p = rand(rects, 7)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    for y0, x0, dy, dx, r, gr, b in p:
        mask = (yy >= y0) & (yy < y0 + 0.4 * dy) & (xx >= x0) & (xx < x0 + 0.4 * dx)
        colour = torch.stack([r, gr, b])[:, None, None]
        img = torch.where(mask, 0.8 * colour + 0.2 * img, img)
    return img.clamp(0.0, 1.0)


def imageShapes(mix: dict) -> List[Tuple[int, int]]:
    """(height, width) of each pool image; the same for every seed."""
    n = int(mix["pool"])
    if "sizes" in mix:
        sizes = mix["sizes"]
        return [(int(sizes[i % len(sizes)][1]), int(sizes[i % len(sizes)][0])) for i in range(n)]
    rng = _rng(mix["shape_seed"])
    lo, hi, step = mix["long_side"]
    shapes = []
    for _ in range(n):
        long = int(rng.integers(lo // step, hi // step + 1)) * step
        a, b = mix["aspects"][int(rng.integers(len(mix["aspects"])))]
        short = max(1, int(round(long * min(a, b) / max(a, b))))
        portrait = rng.random() < float(mix["portrait"])
        shapes.append((long, short) if portrait else (short, long))
    return shapes


def makeImages(mix: dict, seed: int, device) -> Tuple[List[np.ndarray], List[int]]:
    """(pool of uint8 (H, W, 3) arrays, the order of pool indices)."""
    g = _gen(seed, device)
    pool = []
    for h, w in imageShapes(mix):
        img = picture(g, h, w, device)
        pool.append((img * 255).round().to(torch.uint8).permute(1, 2, 0).contiguous().cpu().numpy())
    order = [int(i) for i in _rng(seed).permutation(len(pool))]
    return pool, order


def clipMotion(mix: dict, seed: int):
    """Background and patch velocities (vy, vx), whole pixels a frame."""
    rng = _rng(seed)
    s = int(mix["max_speed"])
    draw = lambda: (int(rng.integers(-s, s + 1)), int(rng.choice([-1, 1]) * rng.integers(1, s + 1)))
    return draw(), draw()


def makeClip(mix: dict, seed: int, device) -> List[bytes]:
    """``frames`` raw 16-bit BGR frames."""
    h, w, n = int(mix["height"]), int(mix["width"]), int(mix["frames"])
    g = _gen(seed, device)
    (vy, vx), (py, px) = clipMotion(mix, seed)
    ch, cw = h + n * abs(vy) + 1, w + n * abs(vx) + 1
    canvas = picture(g, ch, cw, device, rects=24)
    ph, pw = h // 3, w // 3
    patch = picture(g, ph, pw, device, rects=4)
    oy, ox = (n * abs(vy) if vy < 0 else 0), (n * abs(vx) if vx < 0 else 0)
    frames = []
    for i in range(n):
        f = canvas[:, oy + i * vy : oy + i * vy + h, ox + i * vx : ox + i * vx + w].clone()
        y = (h // 3 + i * py) % (h - ph)
        x = (w // 3 + i * px) % (w - pw)
        f[:, y : y + ph, x : x + pw] = patch
        q = (f * 65535).round().to(torch.int32).flip(0).permute(1, 2, 0)  # BGR, HWC
        frames.append(q.to(torch.int16).cpu().numpy().view(np.uint16).tobytes())
    return frames
