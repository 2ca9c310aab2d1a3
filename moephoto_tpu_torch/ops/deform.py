"""Modulated deformable 3x3 convolution, DCNv2 (K3).

:func:`deformConv2d` replaces the Pallas kernel of the JAX package
(``moephoto_tpu/ops/dcnkernel.py:184`` ``dcnDensePallas``, body
``_dcnKernel`` :57, dispatched by ``ops/deform.py:166`` ``deformConv2d``)
with CUDA kernels written for Hopper (``csrc/dcn.cu``: one that contracts
on the tensor cores, for bf16 at widths that tile, and one on the CUDA
cores for everything else; :func:`pickInstance` chooses).  The TPU kernel
folds bilinear sampling into hat weights over a [-M, M]^2 shift window,
exact only while every |offset| <= M, so the JAX package picks a tier
(M = 1, M = 3 or an XLA gather) from the largest |offset| of the call.
The card gathers from any address, so the kernel computes the function
itself for any offset: no window, no tiers, and no host sync to choose
one.  On CPU tensors the wrapper runs :func:`deformConv2dPlain`.

Semantics (torchvision ``deform_conv2d``, JAX ``_deformConvGather``
``deform.py:96``): for output pixel p, tap k of the 3x3 kernel and input
channel c of deformable group g = c // (C / dg),

    out[p] = bias + sum_k sum_c W[:, c, k] * m[g, k] * bilinear(x[..., c], p + p_k + delta[g, k])

with delta in (y, x) order; a bilinear corner outside the image reads
zero.  Rounding follows the Pallas body: each sampled and modulated value
is formed in fp32 and rounded to x's dtype before the contraction
(``dcnkernel.py:153-155``), the contraction accumulates in fp32, and the
bias is added in fp32 before one rounding to x's dtype (the order of
``_deformConvDense``; the Pallas path rounds before and after the bias,
which differs by at most one bf16 ulp).

Coordinates: each sampling coordinate is clamped to [-2, side + 1] (NaN to
-2) before it becomes an index, so an offset of 1e6 reads nothing out of
bounds and contributes zero, as in the gather path; the bilinear weight
comes from the unclamped coordinate, so a NaN offset gives NaN at its
output pixel.

Layouts are the JAX package's: x (B, H, W, C); offset (B, H, W, 2 dg 9),
read as (dg, 9, 2) with y first; mask (B, H, W, dg 9), already through the
sigmoid.  The weight is the torch layout (Cout, C, 3, 3) the checkpoint
holds.

K3's row-sharded tier (:func:`deformConv2dSpmd`, and :func:`deformConv2d`
under ``spmdTracing()``) replaces the JAX package's SPMD tier
(``moephoto_tpu/ops/deform.py:225-285``, the Pallas sampler per shard inside
``shard_map`` with a margin-3 halo): the port's own kernel runs per row
shard with a halo of the sampler's global row reach, given the shard's row
offset and the global height, so each row is bit-equal to the
single-device call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import nn

from moephoto_tpu_torch.ops import _build
from moephoto_tpu_torch.ops._prep import PrepCache
from moephoto_tpu_torch.ops.warp import _coords, _unitChannel, rowReach
from moephoto_tpu_torch.parallel import sharded, temporal
from moephoto_tpu_torch.parallel.temporal import spmdTracing

SOURCE = "dcn.cu"
MAX_C, MAX_COUT = 128, 128
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on Hopper
MMA_TILE = 256       # pixels (16 x 16) a block of the tensor-core instance contracts at a time
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCES = {"cuda_core": 0, "mma": 1}


def mmaSmemBytes(C: int, Cout: int) -> int:
    """Shared memory of one block of the tensor-core instance: the bf16
    weights, two (256, C + 8) bf16 sample buffers, two sets of pixel
    coordinates."""
    return 9 * C * Cout * 2 + 2 * MMA_TILE * (C + 8) * 2 + 2 * MMA_TILE * 16


def pickInstance(dtype, C: int, Cout: int, dg: int, aligned: bool = True) -> str:
    """Which kernel a call launches: ``"mma"`` (the contraction on the tensor
    cores) for bf16 x with C and Cout multiples of 16, groups of a multiple
    of 8 channels and x aligned for 16-byte corner loads (``aligned``: its
    address and batch, row and pixel strides), while the weights fit in
    shared memory; else ``"cuda_core"``."""
    if (dtype == torch.bfloat16 and aligned and C % 16 == 0 and Cout % 16 == 0 and C % dg == 0
            and (C // dg) % 8 == 0 and mmaSmemBytes(C, Cout) <= SMEM_LIMIT):
        return "mma"
    return "cuda_core"


def packTaps(taps: torch.Tensor) -> torch.Tensor:
    """(9, C, Cout) ``[k][c][o]`` -> (9, C * Cout) in the order the
    tensor-core instance reads its B fragments: k-step j, column tile n,
    lane (g, t), then ``W[k][16j + 8h + 2t + e][8n + g]`` over (h, e)."""
    _, C, Cout = taps.shape
    v = taps.reshape(9, C // 16, 2, 4, 2, Cout // 8, 8)  # k, j, h, t, e, n, g
    return v.permute(0, 1, 5, 6, 3, 2, 4).reshape(9, C * Cout).contiguous()


def unpackTaps(packed: torch.Tensor, C: int, Cout: int) -> torch.Tensor:
    """Inverse of :func:`packTaps`: (9, C * Cout) -> (9, C, Cout)."""
    v = packed.reshape(9, C // 16, Cout // 8, 8, 4, 2, 2)  # k, j, n, g, t, h, e
    return v.permute(0, 1, 5, 4, 6, 2, 3).reshape(9, C, Cout).contiguous()


def prepareTaps(weight: torch.Tensor, dtype, instance: str) -> torch.Tensor:
    """The kernel's weight argument from the checkpoint's (Cout, C, 3, 3):
    (9, C, Cout) taps in ``dtype``, packed for the tensor-core instance."""
    Cout, C = weight.shape[:2]
    taps = weight.to(dtype).permute(2, 3, 1, 0).reshape(9, C, Cout).contiguous()
    return packTaps(taps) if instance == "mma" else taps


def deformConv2dPlain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], deformableGroups: int, padding: int = 1,
                      dilation: int = 1, rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Torch-op version of the kernel, the exact gather form: every
    sampled value with the kernel's fp32 operations in its order, then one
    fp32 matrix product per tap.  -> (B, H, W, Cout) in x's dtype.

    ``rows = (out0, img0, full)`` convolves a row window (K3's tier):
    offset, mask and the output are the global rows [out0, out0 + H) of an
    image of ``full`` rows and ``x`` holds its rows [img0, img0 +
    x.shape[1]); coordinates and the inside test are the global image's,
    and a corner outside ``x``'s rows reads zero."""
    B, H, W = offset.shape[:3]
    C, Hx = x.shape[3], x.shape[1]
    out0, img0, full = rows if rows is not None else (0, 0, Hx)
    Cout, _, kh, kw = weight.shape
    K, dg = kh * kw, deformableGroups
    cg = C // dg
    dev = x.device
    off = offset.reshape(B, H, W, dg, K, 2)
    m = mask.reshape(B, H, W, dg, K)
    table = x.reshape(B * Hx * W * dg, cg)
    base = (torch.arange(B, device=dev) * (Hx * W)).reshape(B, 1, 1, 1)
    group = torch.arange(dg, device=dev)
    ys = torch.arange(out0, out0 + H, dtype=torch.float32, device=dev).reshape(1, H, 1, 1)
    xs = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, 1, W, 1)
    taps = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(K, C, Cout).float()
    zero = torch.zeros((), device=dev)
    out = torch.zeros((B * H * W, Cout), dtype=torch.float32, device=dev)
    for k in range(K):
        ky, kx = divmod(k, kw)
        y0, y1, wy = _coords((ys + float(ky * dilation - padding)) + off[..., k, 0].float(), full)
        x0, x1, wx = _coords((xs + float(kx * dilation - padding)) + off[..., k, 1].float(), W)

        def tap(yi, xi):
            yw = yi - img0  # the row of x's window
            inside = (yi >= 0) & (yi <= full - 1) & (yw >= 0) & (yw <= Hx - 1) & (xi >= 0) & (xi <= W - 1)
            idx = (base + yw.clamp(0, Hx - 1) * W + xi.clamp(0, W - 1)) * dg + group
            return torch.where(inside[..., None], table[idx].float(), zero)  # (B, H, W, dg, cg)

        wx, wy = wx[..., None], wy[..., None]
        ux, uy = 1 - wx, 1 - wy
        top = tap(y0, x0) * ux + tap(y0, x1) * wx
        bot = tap(y1, x0) * ux + tap(y1, x1) * wx
        samp = (top * uy + bot * wy) * m[..., k, None].float()
        out = out + samp.to(x.dtype).float().reshape(B * H * W, C) @ taps[k]
    if bias is not None:
        out = out + bias.float()
    return out.reshape(B, H, W, Cout).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        i64, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.dcnForward.argtypes = ([i32, i32, i32, i32] + [ptr, i64, i64, i64] * 3 + [ptr, ptr, ptr]
                                   + [i32] * 12 + [ptr])
        lib.dcnForward.restype = i32
        lib.dcnErrorString.argtypes = [i32]
        lib.dcnErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def deformConv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], deformableGroups: int, padding: int = 1,
                 dilation: int = 1, instance: Optional[str] = None, cache: Optional[PrepCache] = None,
                 rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """DCNv2 3x3: (B, H, W, C) -> (B, H, W, Cout) in x's dtype.

    x, offset and mask fp32 or bf16 (each its own), with any batch, row
    and pixel strides; C a multiple of ``deformableGroups``, C <= 128,
    Cout <= 128.  CPU tensors take :func:`deformConv2dPlain`; CUDA tensors
    launch a kernel or raise.  ``instance`` forces ``"mma"`` or
    ``"cuda_core"`` (the latter takes every shape) over
    :func:`pickInstance`; ``cache`` keeps the kernel's form of ``weight``
    between calls; ``deformConv2d.lastInstance`` names what the last launch
    ran.  ``rows = (out0, img0, full)`` convolves a row window, as
    :func:`deformConv2dPlain` says.  Under :func:`spmdTracing` with a video
    mesh, whole tensors take :func:`deformConv2dSpmd`."""
    if spmdTracing() and rows is None and temporal.videoMesh() is not None:
        return deformConv2dSpmd(x, offset, mask, weight, bias, deformableGroups, padding, dilation,
                                instance=instance, cache=cache)
    if all(t.device.type == "cpu" for t in (x, offset, mask)):
        return deformConv2dPlain(x, offset, mask, weight, bias, deformableGroups, padding, dilation, rows)
    others = (offset, mask, weight) + ((bias,) if bias is not None else ())
    if not (x.is_cuda and all(t.device == x.device for t in others)):
        raise ValueError(f"deformConv2d: x on {x.device}, offset on {offset.device}, mask on {mask.device}, "
                         f"weight and bias on {weight.device}")
    if any(t.dtype not in _TYPES for t in (x, offset, mask)):
        raise TypeError(f"deformConv2d takes fp32 or bf16 tensors, got {x.dtype}/{offset.dtype}/{mask.dtype}")
    B, H, W = offset.shape[:3]
    C = x.shape[3]
    out0, img0, full = rows if rows is not None else (0, 0, H)
    Cout, dg = weight.shape[0], deformableGroups
    if (weight.shape != (Cout, C, 3, 3) or offset.shape != (B, H, W, 2 * dg * 9) or mask.shape != (B, H, W, dg * 9)
            or x.shape[0] != B or x.shape[2] != W or (rows is None and x.shape[1] != H)
            or not (0 <= out0 and out0 + H <= full and 0 <= img0 and img0 + x.shape[1] <= full)):
        raise ValueError(f"deformConv2d: x {tuple(x.shape)}, offset {tuple(offset.shape)}, "
                         f"mask {tuple(mask.shape)}, weight {tuple(weight.shape)}, dg {dg}, rows {rows}")
    if not (dg >= 1 and C % dg == 0 and C <= MAX_C and 1 <= Cout <= MAX_COUT):
        raise ValueError(f"deformConv2d: C={C}, Cout={Cout}, dg={dg} (C a multiple of dg, C <= {MAX_C}, "
                         f"Cout <= {MAX_COUT})")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, offset, mask = _unitChannel(x), _unitChannel(offset), _unitChannel(mask)
    aligned = x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])
    picked = pickInstance(x.dtype, C, Cout, dg, aligned)
    instance = instance or picked
    if instance not in _INSTANCES or (instance == "mma" and picked != "mma"):
        raise ValueError(f"deformConv2d: no {instance} instance for {x.dtype}, C={C}, Cout={Cout}, dg={dg}, "
                         f"x aligned to 16 bytes: {aligned}")
    build = lambda: prepareTaps(weight, x.dtype, instance)
    taps = cache.get((x.dtype, instance), [weight], build) if cache is not None else build()
    b = bias.float().contiguous() if bias is not None else None
    lib = _library()
    with torch.cuda.device(x.device):  # the launch goes to the tensors' card, on its stream
        err = lib.dcnForward(_INSTANCES[instance], _TYPES[x.dtype], _TYPES[offset.dtype], _TYPES[mask.dtype],
                             x.data_ptr(), *x.stride()[:3], offset.data_ptr(), *offset.stride()[:3],
                             mask.data_ptr(), *mask.stride()[:3], taps.data_ptr(),
                             b.data_ptr() if b is not None else None, out.data_ptr(),
                             B, H, W, C, Cout, dg, padding, dilation, out0, img0, x.shape[1], full,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deformConv2d launch failed: {lib.dcnErrorString(err).decode()}")
    deformConv2d.launches += 1
    deformConv2d.lastInstance = instance
    return out


deformConv2d.launches = 0
deformConv2d.lastInstance = None


def dcnRowReach(offsetParts, padding: int = 1, dilation: int = 1) -> int:
    """The sampler's global row reach: ceil of the largest finite |dy| over
    every part (one host read), plus one for the bilinear corner, plus the
    farthest tap row, max(pad, 2 dil - pad)."""
    return rowReach(offsetParts, slice(0, None, 2)) + 1 + max(padding, abs(2 * dilation - padding))


def deformConv2dSpmd(x, offset, mask, weight: torch.Tensor, bias: Optional[torch.Tensor], deformableGroups: int,
                     padding: int = 1, dilation: int = 1, instance: Optional[str] = None,
                     cache: Optional[PrepCache] = None):
    """:func:`deformConv2d` row-sharded (K3's tier, the port of
    ``moephoto_tpu/ops/deform.py:225-285``): ``x``, ``offset`` and ``mask`` as
    RowShards on axis 1 with one set of bounds (or whole tensors, then cut
    over the video mesh and the result gathered).  The halo is the
    sampler's global row reach (:func:`dcnRowReach`), read once; each
    shard's window of x takes rows from as many shards as that spans, and
    the kernel (or its plain version on a CPU shard) convolves the shard's
    rows at their global coordinates, so each output row is bit-equal to
    the single-device :func:`deformConv2d`'s.  Weight and bias go to each
    shard's device."""
    whole = not isinstance(x, sharded.RowShards)
    if whole:
        devices = temporal.videoMesh().flat
        x, offset, mask = (sharded.RowShards.split(t, devices, 1) for t in (x, offset, mask))
    for t in (offset, mask):
        if t.axis != 1 or x.axis != 1 or t.bounds != x.bounds:
            raise ValueError(f"deformConv2dSpmd: rows {x.bounds} of x, {t.bounds} of offset or mask")
        if t.devices != x.devices:
            raise ValueError(f"deformConv2dSpmd: x shards on {x.devices}, offset or mask shards on {t.devices}")
    reach = dcnRowReach(offset.parts, padding, dilation)
    H, outs, params = x.rows, [], {}
    for j in range(x.n):
        a, b = x.rowsOf(j)
        lo, hi = max(0, a - reach), min(H, b + reach)
        dev = x.parts[j].device
        if dev not in params:
            params[dev] = (weight.to(dev), bias.to(dev) if bias is not None else None,
                           cache if dev == weight.device else None)
        w, bb, c = params[dev]
        out = deformConv2d(x.window(j, lo, hi), offset.parts[j], mask.parts[j], w, bb, deformableGroups, padding,
                           dilation, instance=instance, cache=c, rows=(a, lo, H))
        if out.is_cuda:
            deformConv2dSpmd.launches += 1
        outs.append(out)
    res = sharded.RowShards(outs, x.bounds, 1)
    return res.gather() if whole else res


deformConv2dSpmd.launches = 0


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 with its offsets and mask predicted from ``feat`` (JAX
    ``modulatedDeformConvPack`` ``deform.py:307``): ``conv_offset`` gives
    3 dg 9 channels; the first 2 dg 9 are the offsets, read in place, and
    the mask is the sigmoid of the rest.  Keys ``weight``, ``bias``,
    ``conv_offset.*`` as the reference checkpoint's."""

    def __init__(self, cin: int, cout: int, deformableGroups: int = 8):
        super().__init__()
        self.deformableGroups = deformableGroups
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset = nn.Conv2d(cin, deformableGroups * 3 * 9, 3, 1, 1)
        # the kernel's form of ``weight``, made once per (dtype, instance); a write to the
        # weight (load_state_dict) or a move of the module makes the next call build it anew
        self._tapsCache = PrepCache()

    def offsetsOf(self, feat: torch.Tensor) -> torch.Tensor:
        """``conv_offset`` on ``feat`` (NHWC): the offsets and the mask's logits."""
        return self.conv_offset(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def sample(self, x, out):
        """The DCN on ``x`` with :meth:`offsetsOf`'s output ``out``, both NHWC
        tensors, or both row shards (K3's tier, :func:`deformConv2dSpmd`, as a
        row-sharded stage computes ``out`` in a segment of its own)."""
        n = 2 * self.deformableGroups * 9
        if isinstance(x, sharded.RowShards):
            return deformConv2dSpmd(x, out.map(lambda p: p[..., :n]), out.map(lambda p: torch.sigmoid(p[..., n:])),
                                    self.weight, self.bias, self.deformableGroups, cache=self._tapsCache)
        return deformConv2d(x, out[..., :n], torch.sigmoid(out[..., n:]), self.weight, self.bias,
                            self.deformableGroups, cache=self._tapsCache)

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """x, feat NHWC -> NHWC."""
        return self.sample(x, self.offsetsOf(feat))
