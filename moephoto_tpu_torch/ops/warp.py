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
"""

from __future__ import annotations

import ctypes

import torch

from moephoto_tpu_torch.ops import _build

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


def warpPlain(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Torch-op version of the kernel: (B, H, W, C), flow (B, H, W, 2) ->
    (B, H, W, C) in ``img``'s dtype."""
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode {padding_mode!r} not in {tuple(_MODES)}")
    B, H, W, C = img.shape
    dev = img.device
    sx = torch.arange(W, dtype=torch.float32, device=dev) + flow[..., 0].float()
    sy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + flow[..., 1].float()
    x0, x1, wx = _coords(sx, W)
    y0, y1, wy = _coords(sy, H)
    table = img.reshape(B, H * W, C)

    def tap(yi, xi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, H * W, 1).expand(B, H * W, C)
        v = torch.gather(table, 1, idx).float().reshape(B, H, W, C)
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            v = torch.where(inside[..., None], v, torch.zeros((), device=dev))
        return v

    wx, wy = wx[..., None], wy[..., None]
    ux, uy = 1 - wx, 1 - wy
    top = tap(y0, x0) * ux + tap(y0, x1) * wx
    bot = tap(y1, x0) * ux + tap(y1, x1) * wx
    return (top * uy + bot * wy).to(img.dtype)


def backWarpFlow(flow: torch.Tensor) -> torch.Tensor:
    """Fold ``backWarp``'s normalisation quirk into a pixel-offset flow.

    ``backWarp`` (reference videoSR.py:43-72) normalises grid + flow by W
    and denormalises by W - 1 (align_corners), so it samples at
    (x + u)(W - 1)/W, not x + u: with u' = u(W - 1)/W - x/W, exact warping
    by u' is ``backWarp`` by u (JAX ``backWarpBounded``, warp.py:243)."""
    B, H, W, _ = flow.shape
    dev = flow.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    u, v = flow[..., 0].float(), flow[..., 1].float()
    up = u * ((W - 1.0) / W) - xs[None, None, :] * (1.0 / W)
    vp = v * ((H - 1.0) / H) - ys[None, :, None] * (1.0 / H)
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
                                     + [ctypes.c_int] * 5 + [ptr])
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


def warp(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Bilinear warp at (x + u, y + v): (B, H, W, C) -> (B, H, W, C).

    ``img`` fp32 or bf16 with 1 <= C <= 256, ``flow`` (B, H, W, 2) fp32 or
    bf16; any batch, row and pixel strides.  CPU tensors take
    :func:`warpPlain`; CUDA tensors launch the kernel or raise.
    """
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warpPlain(img, flow, padding_mode)
    if not (img.is_cuda and flow.device == img.device):
        raise ValueError(f"warp: img on {img.device}, flow on {flow.device}")
    if img.dtype not in _TYPES or flow.dtype not in _TYPES:
        raise TypeError(f"warp takes fp32 or bf16 tensors, got {img.dtype}/{flow.dtype}")
    if padding_mode not in _MODES:
        raise ValueError(f"padding_mode {padding_mode!r} not in {tuple(_MODES)}")
    if img.ndim != 4 or flow.shape != img.shape[:3] + (2,):
        raise ValueError(f"warp: image {tuple(img.shape)}, flow {tuple(flow.shape)}")
    B, H, W, C = img.shape
    if not 1 <= C <= MAX_C:
        raise ValueError(f"warp: C={C} not in 1..{MAX_C}")
    out = torch.empty((B, H, W, C), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    img, flow = _unitChannel(img), _unitChannel(flow)
    lib = _library()
    err = lib.warpBilinear(_TYPES[img.dtype], _TYPES[flow.dtype], img.data_ptr(), *img.stride()[:3],
                           flow.data_ptr(), *flow.stride()[:3], out.data_ptr(), B, H, W, C,
                           _MODES[padding_mode], torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp launch failed: {lib.warpErrorString(err).decode()}")
    warp.launches += 1
    return out


warp.launches = 0
