"""Fused sub-pixel upsample + heads for MoeNet_lite2.

:func:`fusedUpHeads` replaces the Pallas kernel of the JAX package
(``moephoto_tpu/ops/fusedup.py:93``) with CUDA kernels written for
Hopper (``csrc/fusedup.cu``, whose header says what bounds them and how
each design keeps the 4**nUps expansion out of device memory).  Three
instances share the source: ``wgmma`` (bf16, c = 48: the lite models as
they run) and ``mma`` (mma.sync; bf16, c = 96: packed) run the stage products
on the tensor cores, ``cuda_core`` on the fp32 CUDA cores (fp32, and any
other c that is a multiple of 4); :func:`pickInstance` chooses.
On a CPU tensor the wrapper runs :func:`fusedUpHeadsPlain`, the same
arithmetic in torch ops with the same rounding points.

What a kernel reads (stacked or packed weights, biases, slopes, head
rows) is an :class:`UpWeights`, made by :func:`prepare` once for a
(dtype, device) and reusable across calls; a ``PrepCache``
(``ops/_prep.py``) keeps one per module and drops it when a parameter
changes.

Layout contract (as ``models/sr.py``'s nested deferred layout): output
column index = (((s1 * 4 + s2) * 4 + ...) * cout + plane) with
s_i = rowOffset_i * 2 + colOffset_i, the axis nesting
``interleaveNested`` expects.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from moephoto_tpu_torch.ops import _build
from moephoto_tpu_torch.ops._prep import PrepCache  # noqa: F401  (kept on the modules that call fusedUpHeads)

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


# ---- what the kernels read -------------------------------------------------

WGMMA_WIDTH = 48             # the wgmma instance's width; it takes cout <= 2
MMA_WIDTH = 96               # the mma.sync instance's width
MMA_WARPS = 12               # warps of the mma.sync block, as kMmaWarps in csrc/fusedup.cu
SMEM_LIMIT = 232448          # bytes of shared memory a block may take on Hopper


def mmaFloatCount(c: int, nUps: int, cout: int) -> int:
    """Floats of the mma.sync instance's fp32 block, padded to 16 bytes."""
    return (2 * (nUps * 5 * c + cout * c) + cout + 3) // 4 * 4


def wgmmaFloatCount(nUps: int, cout: int) -> int:
    """Floats of the wgmma instance's fp32 block, padded to 16 bytes."""
    return (2 * nUps * WGMMA_WIDTH + cout + 3) // 4 * 4


def wgmmaWarps(nUps: int) -> int:
    """Warps of the wgmma block, as kWgWarps in csrc/fusedup.cu."""
    return 8 if nUps == 3 else 12


def tensorSmemBytes(instance: str, c: int, nUps: int, cout: int, weightsResident: bool = True) -> int:
    """Shared memory of one block of a tensor-core instance: both branches'
    bf16 weights when resident, the fp32 block, and a (rows, 4**nUps * cout
    + 1) fp32 output tile per warp of 16 rows.  ``mma``: 12 warps;
    ``wgmma``: 12 (8 at nUps = 3), and 64 weight rows a matrix (the bias
    rides in a fourth k-step)."""
    if instance == "wgmma":
        return 2 * nUps * 4 * (c + 16) * c * 2 + 4 * (wgmmaFloatCount(nUps, cout)
                                                      + wgmmaWarps(nUps) * 16 * (4**nUps * cout + 1))
    weights = 2 * nUps * 4 * c * c * 2 if weightsResident else 0
    return weights + 4 * (mmaFloatCount(c, nUps, cout) + MMA_WARPS * 16 * (4**nUps * cout + 1))


def pickInstance(dtype, c: int, nUps: int, cout: int) -> str:
    """Which kernel a call launches.  bf16 rows take ``"wgmma"`` at c = 48
    with cout <= 2 while weights and output tiles fit in shared memory, and
    ``"mma"`` (mma.sync, weights resident or read through L1) at c = 96
    while its tiles fit; fp32 and everything else take ``"cuda_core"``."""
    if dtype == torch.bfloat16:
        if c == WGMMA_WIDTH and cout <= 2 and tensorSmemBytes("wgmma", c, nUps, cout) <= SMEM_LIMIT:
            return "wgmma"
        if c == MMA_WIDTH and tensorSmemBytes("mma", c, nUps, cout, False) <= SMEM_LIMIT:
            return "mma"
    return "cuda_core"


def instanceVariant(instance: str, c: int, nUps: int, cout: int) -> str:
    """The instance and, for ``mma``, where it keeps its weights."""
    if instance != "mma":
        return instance
    resident = tensorSmemBytes("mma", c, nUps, cout) <= SMEM_LIMIT
    return "mma_weights_in_smem" if resident else "mma_weights_from_l1"


def split3(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> three bf16 terms stacked on a new first axis whose fp32 sum
    is ``x`` exactly (8 significant bits each): how the wgmma instance
    carries fp32 biases and head rows through bf16 tensor-core products."""
    x = x.float()
    hi = x.bfloat16()
    r1 = x - hi.float()
    mid = r1.bfloat16()
    lo = (r1 - mid.float()).bfloat16()
    return torch.stack([hi, mid, lo])


def packStageWeights(w: torch.Tensor) -> torch.Tensor:
    """(4, c, c) ``[sub][ci][co]`` -> (4, c * c) in the order the
    mma.sync instance reads its B fragments: k-step j, tile pair i2,
    lane (g, t), then ``W[16j + 8h + 2t + e][16 i2 + 8q + g]`` over (q, h, e)."""
    c = w.shape[-1]
    v = w.reshape(4, c // 16, 2, 4, 2, c // 16, 2, 8)  # sub, j, h, t, e, i2, q, g
    return v.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(4, c * c).contiguous()


def unpackStageWeights(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`packStageWeights`: (4, c * c) -> (4, c, c)."""
    v = packed.reshape(4, c // 16, c // 16, 8, 4, 2, 2, 2)  # sub, j, i2, g, t, q, h, e
    return v.permute(0, 1, 6, 4, 7, 2, 5, 3).reshape(4, c, c).contiguous()


def packStageWeightsWgmma(w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(4, c, c) bf16 ``[sub][ci][co]`` and (4, c) fp32 biases -> (4, (c + 16)
    * c) bf16, the wgmma instance's B operand: rows c..c+2 hold the bias as
    :func:`split3` terms, rows above are zero, and the (c + 16, c) matrix
    lies as 8 x 8 core matrices of 128 bytes, ordered k-step j, k half kb,
    column block nb, then ``W[16j + 8kb + e][8nb + r]`` over (r, e)."""
    c = w.shape[-1]
    full = torch.zeros((4, c + 16, c), dtype=torch.bfloat16, device=w.device)
    full[:, :c] = w
    full[:, c : c + 3] = split3(bias).permute(1, 0, 2)
    v = full.reshape(4, c // 16 + 1, 2, 8, c // 8, 8)  # sub, j, kb, e, nb, r
    return v.permute(0, 1, 2, 4, 5, 3).reshape(4, (c + 16) * c).contiguous()


def unpackStageWeightsWgmma(packed: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`packStageWeightsWgmma`: -> ((4, c, c) weights, (4, c)
    fp32 biases, the sum of their three terms)."""
    v = packed.reshape(4, c // 16 + 1, 2, c // 8, 8, 8)  # sub, j, kb, nb, r, e
    full = v.permute(0, 1, 2, 5, 3, 4).reshape(4, c + 16, c)
    terms = full[:, c : c + 3].float()
    return full[:, :c].contiguous(), (terms[:, 0] + terms[:, 1]) + terms[:, 2]


def packHeadFragments(head: torch.Tensor) -> torch.Tensor:
    """(cout, c) fp32 head rows, cout <= 2 -> (c // 16, 32, 4) bf16: per
    k-step and lane (g, t) the mma.sync B fragment of the (c, 8) matrix
    whose columns 4p..4p+2 hold plane p's :func:`split3` terms:
    ``H[16j + 2t + e][g]`` for e in (0, 1), then the same 8 rows on."""
    cout, c = head.shape
    cols = torch.zeros((8, c), dtype=torch.bfloat16, device=head.device)
    for p in range(cout):
        cols[4 * p : 4 * p + 3] = split3(head[p])
    v = cols.t().reshape(c // 16, 2, 4, 2, 8)  # j, h, t, e, g
    return v.permute(0, 4, 2, 1, 3).reshape(c // 16, 32, 4).contiguous()


def unpackHeadFragments(frag: torch.Tensor, cout: int) -> torch.Tensor:
    """Inverse of :func:`packHeadFragments`: -> (cout, c) fp32 head rows."""
    ks = frag.shape[0]
    cols = frag.reshape(ks, 8, 4, 2, 2).permute(0, 3, 2, 4, 1).reshape(ks * 16, 8).t().float()  # (8, c)
    return torch.stack([(cols[4 * p] + cols[4 * p + 1]) + cols[4 * p + 2] for p in range(cout)])


@dataclasses.dataclass
class UpWeights:
    """One module's up path as a kernel reads it, for one dtype and device.

    ``tensors`` are the kernel's weight arguments in call order: for
    ``wgmma`` the bf16 block (2, nUps, 4, (c + 16) * c) of
    :func:`packStageWeightsWgmma`, the heads' fragments (2, c // 16, 32, 4)
    of :func:`packHeadFragments` and the fp32 block (slopes (2, nUps, c),
    then the summed head bias); for ``mma`` the bf16 block (2, nUps, 4,
    c * c) of :func:`packStageWeights` and the fp32 block
    (per branch biases, slopes, head rows; then the summed head bias); for
    ``cuda_core`` the fp32 stacks wRes, bRes, sRes, wIm, bIm, sIm and the
    head rows hr, hi, hb.  ``params`` is the dictionary it was made from,
    which the plain version reads."""

    params: Dict[str, torch.Tensor]
    nUps: int
    dtype: torch.dtype
    device: torch.device
    c: int
    cout: int
    instance: str
    tensors: Tuple[torch.Tensor, ...]
    # mma: every PReLU slope lies in [0, 1]; wgmma: and each stage's slopes are one number
    # (read once, here: it costs a device sync)
    slope01: bool = False


def prepare(params, nUps: int, dtype, device, instance: Optional[str] = None) -> UpWeights:
    """Everything :func:`fusedUpHeads` needs from ``params`` for rows of
    ``dtype`` on ``device``; ``instance`` overrides :func:`pickInstance`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    resStages, imStages, hr, hi, hb = prepWeights(params, nUps, dtype)
    cout, c = hr.shape
    if c > MAX_C or c % 4:
        raise ValueError(f"fusedUpHeads: c={c} must be a multiple of 4 and <= {MAX_C}")
    if cout > MAX_COUT or hi.shape != hr.shape or resStages[0][0].shape != (4, c, c):
        raise ValueError(f"fusedUpHeads: head shape {tuple(hr.shape)} for c={c}")
    picked = pickInstance(dtype, c, nUps, cout)
    instance = instance or picked
    if instance not in (picked, "cuda_core"):
        raise ValueError(f"fusedUpHeads: no {instance} instance for {dtype}, c={c}, nUps={nUps}, cout={cout}")
    both = (resStages, imStages)
    slopes = torch.stack([torch.stack([s for _, _, s in stages]) for stages in both])  # (2, nUps, c)
    if instance == "wgmma":
        packed = torch.stack([torch.stack([packStageWeightsWgmma(w, b) for w, b, _ in stages]) for stages in both])
        frags = torch.stack([packHeadFragments(hr), packHeadFragments(hi)])
        fblock = torch.zeros(wgmmaFloatCount(nUps, cout), dtype=torch.float32, device=slopes.device)
        fblock[: slopes.numel()] = slopes.reshape(-1)
        fblock[slopes.numel() : slopes.numel() + cout] = hb.float()
        tensors = (packed.to(device).contiguous(), frags.to(device), fblock.to(device))
        # the kernel's quick PReLU: every stage's slopes one number in [0, 1]
        slope01 = bool(((slopes == slopes[..., :1]) & (slopes >= 0) & (slopes <= 1)).all())
    elif instance == "mma":
        packed = torch.stack([torch.stack([packStageWeights(w) for w, _, _ in stages]) for stages in both])
        flat = []
        for stages, head in ((resStages, hr), (imStages, hi)):
            flat += [b.reshape(-1) for _, b, _ in stages] + [s for _, _, s in stages] + [head.reshape(-1)]
        flat = torch.cat([t.float() for t in flat] + [hb.float()])
        fblock = torch.zeros(mmaFloatCount(c, nUps, cout), dtype=torch.float32, device=flat.device)
        fblock[: flat.numel()] = flat
        tensors = (packed.to(device, torch.bfloat16).contiguous(), fblock.to(device))
        slope01 = bool(((slopes >= 0) & (slopes <= 1)).all())
    else:
        # fp32 stacks (weights hold values already rounded to the working dtype)
        stack = lambda stages, i: torch.stack([s[i] for s in stages]).to(device, torch.float32).contiguous()
        # fresh allocations: the kernel reads the head rows as float4
        heads = tuple(t.to(device).clone(memory_format=torch.contiguous_format) for t in (hr, hi, hb))
        tensors = tuple(stack(st, i) for st in (resStages, imStages) for i in range(3)) + heads
        slope01 = False
    return UpWeights(params, nUps, dtype, device, c, cout, instance, tensors, slope01)


_mmaArgtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_wgmmaArgtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int] + [ctypes.c_void_p] * 11


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        for fn in (lib.fusedUpHeadsF32, lib.fusedUpHeadsBF16):
            fn.argtypes, fn.restype = _argtypes, ctypes.c_int
        lib.fusedUpHeadsBF16Mma.argtypes, lib.fusedUpHeadsBF16Mma.restype = _mmaArgtypes, ctypes.c_int
        lib.fusedUpHeadsBF16Wgmma.argtypes, lib.fusedUpHeadsBF16Wgmma.restype = _wgmmaArgtypes, ctypes.c_int
        lib.fusedUpHeadsErrorString.argtypes = [ctypes.c_int]
        lib.fusedUpHeadsErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fusedUpHeads(params, res: torch.Tensor, im: torch.Tensor, nUps: int,
                 instance: Optional[str] = None) -> torch.Tensor:
    """Fused up-stages + heads: (M, c) x2 -> (M, 4**nUps * cout).

    ``params`` holds the lite checkpoint's tensors under its keys
    (``ures.i.*``, ``uim.i.*``, ``convt_R1``, ``convt_I1``), torch layout,
    or is an :class:`UpWeights` made from them by :func:`prepare` for these
    rows' dtype and device.  CPU tensors take :func:`fusedUpHeadsPlain`;
    CUDA tensors launch a kernel or raise.  ``instance`` may force ``"cuda_core"``, which takes every
    shape, when ``params`` is a
    dictionary; ``fusedUpHeads.lastInstance`` names what the last launch ran.
    """
    prepared = params if isinstance(params, UpWeights) else None
    if res.device.type == "cpu" and im.device.type == "cpu":
        return fusedUpHeadsPlain(prepared.params if prepared else params, res, im, nUps)
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
    if prepared is None:
        prepared = prepare(params, nUps, res.dtype, res.device, instance)
    elif instance not in (None, prepared.instance):
        raise ValueError(f"fusedUpHeads: weights prepared for {prepared.instance}, asked for {instance}")
    if (prepared.nUps, prepared.dtype, prepared.device, prepared.c) != (nUps, res.dtype, res.device, c):
        raise ValueError(f"fusedUpHeads: weights prepared for nUps={prepared.nUps}, {prepared.dtype} on "
                         f"{prepared.device}, c={prepared.c}; rows are nUps={nUps}, {res.dtype} on {res.device}, c={c}")
    cout = prepared.cout
    out = torch.empty((M, (4**nUps) * cout), dtype=res.dtype, device=res.device)
    if M == 0:
        return out
    # the tensor-core instances read rows in 4-byte pairs and store 16 bytes
    res, im = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (res, im))
    lib = _library()
    stream = torch.cuda.current_stream(res.device).cuda_stream
    weights = [t.data_ptr() for t in prepared.tensors]
    with torch.cuda.device(res.device):  # the launch goes to the tensors' card, on its stream
        if prepared.instance == "wgmma":
            err = lib.fusedUpHeadsBF16Wgmma(res.data_ptr(), im.data_ptr(), M, nUps, cout, *weights,
                                            int(prepared.slope01), out.data_ptr(), stream)
        elif prepared.instance == "mma":
            err = lib.fusedUpHeadsBF16Mma(res.data_ptr(), im.data_ptr(), M, nUps, cout, *weights,
                                          int(prepared.slope01), out.data_ptr(), stream)
        else:
            fn = lib.fusedUpHeadsBF16 if res.dtype == torch.bfloat16 else lib.fusedUpHeadsF32
            err = fn(res.data_ptr(), im.data_ptr(), M, c, nUps, cout, *weights, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fusedUpHeads launch failed: {lib.fusedUpHeadsErrorString(err).decode()}")
    fusedUpHeads.launches += 1
    fusedUpHeads.lastInstance = prepared.instance
    return out


fusedUpHeads.launches = 0
fusedUpHeads.lastInstance = None
