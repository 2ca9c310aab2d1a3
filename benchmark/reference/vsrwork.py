"""IconVSR's work for each output frame of a clip, from the plain reference
(``reference/iconvsr.py``) and its schedule: the FLOPs, and the least time
of the port's kernels K2 (warp) and K3 (DCN) on it.

FLOPs are counted on the reference on the meta device, as ``flops.py``
counts IFRNet-M (convolutions and products; a multiply-add is two
operations), on the frame padded to the model's alignment and scaled
back to the frame's own pixels.  Frame t of n needs both trunks' steps
and the upsampler, SpyNet's backward flow unless t ends its backward
chunk (that step starts from zeros), its forward flow unless t = 0, and
at a keyframe EDVR on its clip and both fusions.

The bounds are re-based as ``bounds.py``'s: the sizes the frame needs,
not the padded rows the port runs.  ``dcnBound`` is a frozen copy of
``chip_smoke.py``'s (lines 1297-1307): x, the offsets and the mask read
once, the output written once, against the peak rate of x's type for
2 * 9 C Cout operations a pixel.  K2 a frame: each flow needed is a
SpyNet pyramid of ``SPY_LEVELS`` warps of the 3-channel frame in the
compute type, flows in the compute type, at 1/32 .. 1 of the frame,
and one propagation warp of the 64-channel state and its flow in fp32
(:func:`bounds.warpBound`).  K3 a keyframe: the four DCNs of EDVR's PCD
on the 7-frame clip, at 1/4, 1/2 and 1 of the frame and the cascade at
full size, x, offsets and mask in the compute type.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import iconvsr
from benchmark.reference.bounds import ITEM, PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, warpBound


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def aligned(h: int, w: int):
    a = iconvsr.ALIGN
    return -(-h // a) * a, -(-w // a) * a


def needsBackwardFlow(t: int, n: int) -> bool:
    return (t + 1) % iconvsr.BACKWARD_CHUNK != 0 and t < n - 1


@functools.lru_cache(maxsize=None)
def _meta(numBlocks: int) -> iconvsr.IconVSR:
    return iconvsr.IconVSR(numBlocks).to("meta")


@functools.lru_cache(maxsize=None)
def partFlops(H: int, W: int, numBlocks: int = iconvsr.NUM_BLOCK) -> dict:
    """FLOPs of each part at the aligned H x W: one step of each trunk, one
    fusion, the upsampler, one SpyNet pyramid, one EDVR clip."""
    m, c = _meta(numBlocks), iconvsr.NUM_FEAT
    e = lambda *s: torch.empty(s, device="meta")
    return {
        "backward": _count(lambda: m.backward_trunk(e(1, c + 3, H, W))),
        "forward": _count(lambda: m.forward_trunk(e(1, 2 * c + 3, H, W))),
        "fusion": _count(lambda: m.backward_fusion(e(1, 2 * c, H, W))),
        "upsample": _count(lambda: m.upsample(e(1, c, H, W))),
        "spynet": sum(_count(lambda lv=lv: m.spynet.basic_module[lv](e(1, 8, H >> (iconvsr.SPY_LEVELS - 1 - lv),
                                                                         W >> (iconvsr.SPY_LEVELS - 1 - lv))))
                      for lv in range(iconvsr.SPY_LEVELS)),
        "edvr": _count(lambda: m.edvr(e(1, iconvsr.REF_TIME, 3, H, W))),
    }


def frameFlops(t: int, n: int, h: int, w: int, numBlocks: int = iconvsr.NUM_BLOCK) -> float:
    """FLOPs output frame t of an n-frame h x w clip needs."""
    H, W = aligned(h, w)
    p = partFlops(H, W, numBlocks)
    total = p["backward"] + p["forward"] + p["upsample"] + p["spynet"] * (needsBackwardFlow(t, n) + (t > 0))
    if iconvsr.isKeyframe(t, n):
        total += 2 * p["fusion"] + p["edvr"]
    return total * (h * w) / (H * W)


def k2FrameBound(t: int, n: int, h: int, w: int, dtype: str) -> float:
    """K2's least seconds for output frame t of an n-frame h x w clip."""
    item = ITEM[dtype]
    pyramid = sum(warpBound(h / 2**lv, w / 2**lv, 3, item, item) for lv in range(iconvsr.SPY_LEVELS))
    propagation = warpBound(h, w, iconvsr.NUM_FEAT, ITEM["float32"], ITEM["float32"])
    return (needsBackwardFlow(t, n) + (t > 0)) * (pyramid + propagation)


def dcnBound(B: int, h: float, w: float, c: int, cout: int, dg: int, item: int, peak: float) -> float:
    """Least seconds for one DCN call on B frames of h x w (see the module's
    docstring); offsets and mask in x's type."""
    px = B * h * w
    nbytes = px * (c * item + 2 * dg * 9 * item + dg * 9 * item + cout * item) + 9 * c * cout * item
    return max(2 * 9 * c * cout * px / peak, nbytes / PEAK_BYTES)


def k3KeyframeBound(h: int, w: int, dtype: str) -> float:
    """K3's least seconds for one keyframe's four DCNs at the clip's own size."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    c, frames = iconvsr.NUM_FEAT, iconvsr.REF_TIME
    return sum(dcnBound(frames, h / s, w / s, c, c, iconvsr.DG, ITEM[dtype], peak) for s in (4, 2, 1, 1))
