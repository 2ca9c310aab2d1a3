"""Fused sub-pixel upsample + heads for MoeNet_lite2.

:func:`fusedUpHeads` replaces the Pallas kernel of the JAX package
(``moephoto_tpu/ops/fusedup.py:93``) with a CUDA kernel written for
Hopper (``csrc/fusedup.cu``, whose header says what bounds it and how the
design keeps the 4**nUps expansion out of device memory).  On a CPU
tensor it runs :func:`fusedUpHeadsPlain`, the same arithmetic in torch
ops with the same rounding points.

Layout contract (as ``models/sr.py``'s nested deferred layout): output
column index = (((s1 * 4 + s2) * 4 + ...) * cout + plane) with
s_i = rowOffset_i * 2 + colOffset_i, the axis nesting
``interleaveNested`` expects.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from moephoto_tpu_torch.ops import _build

SOURCE = "fusedup.cu"
MAX_C, MAX_COUT = 128, 4

Stage = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _prepStage(params: Dict[str, torch.Tensor], key: str, dtype) -> Stage:
    """(4, c, c) per-sub-position weights [sub][ci][co] in ``dtype``,
    (4, c) fp32 biases and a (c,) fp32 PReLU slope (rounded to ``dtype``
    first) for one up stage; sub-positions ordered (row, col).  The
    conv's output channel co*4 + a*2 + b becomes ``w[a*2 + b][:, co]``."""
    wFull = params[key + ".0.weight"][:, :, 0, 0]  # (4c, c): rows co*4 + a*2 + b
    c = wFull.shape[1]
    w = wFull.reshape(c, 2, 2, c).permute(1, 2, 3, 0).reshape(4, c, c)
    bias = params[key + ".0.bias"].reshape(c, 2, 2).permute(1, 2, 0).reshape(4, c)
    slope = params[key + ".2.weight"].to(dtype).float().reshape(-1)
    slope = slope.expand(c) if slope.numel() == 1 else slope
    return w.to(dtype).contiguous(), bias.float().contiguous(), slope.contiguous()


def _prepHead(params: Dict[str, torch.Tensor], key: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cout, c) fp32 head rows + (cout,) fp32 bias (zeros when absent)."""
    w = params[key + ".weight"][:, :, 0, 0].float()
    b = params.get(key + ".bias")
    b = torch.zeros(w.shape[0], device=w.device) if b is None else b.float()
    return w.contiguous(), b


def prepWeights(params, nUps: int, dtype):
    """Stage tensors of both branches and the heads, ready for the kernel."""
    res = [_prepStage(params, f"ures.{i}", dtype) for i in range(nUps)]
    im = [_prepStage(params, f"uim.{i}", dtype) for i in range(nUps)]
    hr, hbr = _prepHead(params, "convt_R1")
    hi, hbi = _prepHead(params, "convt_I1")
    return res, im, hr, hi, hbr + hbi


def fusedUpHeadsPlain(params, res: torch.Tensor, im: torch.Tensor, nUps: int) -> torch.Tensor:
    """Torch-op version of the kernel: (M, c) x2 -> (M, 4**nUps * cout).

    Each stage computes all four sub-positions at once, so a level's rows
    are ordered (m, s1, s2, ...), which is the kernel's column order once
    reshaped to (M, ...)."""
    M, c = res.shape
    dtype = res.dtype
    resStages, imStages, hr, hi, hb = prepWeights(params, nUps, dtype)

    def leaves(x: torch.Tensor, stages: List[Stage]) -> torch.Tensor:
        for w, b, s in stages:
            wCat = w.float().permute(1, 0, 2).reshape(c, 4 * c)  # cols (sub, co)
            y = x.float() @ wCat + b.reshape(-1)
            y = torch.where(y >= 0, y, s.repeat(4) * y)
            x = y.to(dtype).reshape(-1, c)
        return x.float()

    z = leaves(res, resStages) @ hr.t() + leaves(im, imStages) @ hi.t() + hb
    return z.to(dtype).reshape(M, -1)


_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int] + [ctypes.c_void_p] * 11


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        for fn in (lib.fusedUpHeadsF32, lib.fusedUpHeadsBF16):
            fn.argtypes, fn.restype = _argtypes, ctypes.c_int
        lib.fusedUpHeadsErrorString.argtypes = [ctypes.c_int]
        lib.fusedUpHeadsErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fusedUpHeads(params, res: torch.Tensor, im: torch.Tensor, nUps: int) -> torch.Tensor:
    """Fused up-stages + heads: (M, c) x2 -> (M, 4**nUps * cout).

    ``params`` holds the lite checkpoint's tensors under its keys
    (``ures.i.*``, ``uim.i.*``, ``convt_R1``, ``convt_I1``), torch layout.
    CPU tensors take :func:`fusedUpHeadsPlain`; CUDA tensors launch the
    kernel or raise.
    """
    if res.device.type == "cpu" and im.device.type == "cpu":
        return fusedUpHeadsPlain(params, res, im, nUps)
    if not (res.is_cuda and im.device == res.device):
        raise ValueError(f"fusedUpHeads: res on {res.device}, im on {im.device}")
    if res.dtype not in (torch.float32, torch.bfloat16) or im.dtype != res.dtype:
        raise TypeError(f"fusedUpHeads takes fp32 or bf16 rows, got {res.dtype}/{im.dtype}")
    if res.ndim != 2 or im.shape != res.shape:
        raise ValueError(f"fusedUpHeads: shapes {tuple(res.shape)} and {tuple(im.shape)}")
    if not (res.is_contiguous() and im.is_contiguous()):
        raise ValueError("fusedUpHeads takes contiguous (M, c) rows")
    if nUps not in (1, 2, 3):
        raise ValueError(f"fusedUpHeads: nUps={nUps} not in 1..3")
    M, c = res.shape
    if c > MAX_C or c % 4:
        raise ValueError(f"fusedUpHeads: c={c} must be a multiple of 4 and <= {MAX_C}")
    resStages, imStages, hr, hi, hb = prepWeights(params, nUps, res.dtype)
    cout = hr.shape[0]
    if cout > MAX_COUT or hr.shape[1] != c:
        raise ValueError(f"fusedUpHeads: head shape {tuple(hr.shape)} for c={c}")
    # fp32 stacks (weights hold values already rounded to the working dtype)
    stack = lambda stages, i: torch.stack([s[i] for s in stages]).to(res.device, torch.float32).contiguous()
    wR, bR, sR = (stack(resStages, i) for i in range(3))
    wI, bI, sI = (stack(imStages, i) for i in range(3))
    # fresh allocations: the kernel reads the head rows as float4
    hr, hi, hb = (t.to(res.device).clone(memory_format=torch.contiguous_format) for t in (hr, hi, hb))
    out = torch.empty((M, (4**nUps) * cout), dtype=res.dtype, device=res.device)
    if M == 0:
        return out
    lib = _library()
    fn = lib.fusedUpHeadsBF16 if res.dtype == torch.bfloat16 else lib.fusedUpHeadsF32
    ptr = lambda t: t.data_ptr()
    err = fn(
        ptr(res), ptr(im), M, c, nUps, cout,
        ptr(wR), ptr(bR), ptr(sR), ptr(wI), ptr(bI), ptr(sI),
        ptr(hr), ptr(hi), ptr(hb), ptr(out),
        torch.cuda.current_stream(res.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fusedUpHeads launch failed: {lib.fusedUpHeadsErrorString(err).decode()}")
    fusedUpHeads.launches += 1
    return out


fusedUpHeads.launches = 0
