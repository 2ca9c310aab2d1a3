"""LayerNorm over the channels of a channels-last tensor (K8), for NAFNet.

:func:`layerNorm` is ``models/api.LayerNorm2d``'s norm: over the C
channels of each pixel, biased variance, normalised and scaled in fp32,
rounded once to the input's dtype.  :func:`residualLayerNorm` also takes
in the residual that feeds a NAFBlock's second norm: ``z = x + (y + yBias)
* scale``, formed in fp32 and rounded once, then the norm of that rounded
``z``; it returns both.  K8 replaces no TPU kernel: the JAX package's
``layerNorm2d`` (``moephoto_tpu/models/api.py:168``) is jnp that XLA fuses.

The tensors are NCHW views of channels-last memory, as NAFNet's features
are; the outputs are allocated in NHWC and returned as such views.  CPU
tensors take the plain versions (:func:`layerNormPlain`,
:func:`residualLayerNormPlain`: fp32 torch operations, rounded once).  On
the card one launch of ``csrc/layernorm.cu`` takes the whole tensor, on
the current stream, with nothing synchronised or allocated, so it is
captured into ``engine/executor.ModelExec``'s stage graphs; the wrapper
raises on what the kernel does not take (another device, dtype or width,
a layout that is not channels-last, an input that autograd would
differentiate), and never falls back.  Meta tensors
(shape-only runs, such as counting a model's operations) are held to the
kernel's terms and get the plain versions' shapes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from moephoto_tpu_torch.ops import _build

SOURCE = "layernorm.cu"
MIN_C, MAX_C, C_STEP = 32, 1024, 8  # csrc/layernorm.cu: C a multiple of 8 in [32, 1024]
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _param(p: torch.Tensor, dtype) -> torch.Tensor:
    """A per-channel parameter ((C,) or (1, C, 1, 1)) as C values in
    ``dtype``: the features' dtype, as the module applied it before K8."""
    return p.to(dtype).reshape(-1)


def layerNormPlain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm in torch operations on the NHWC view of ``x`` (N, C, H, W):
    mean, biased variance of the differences, ``d * rsqrt(var + eps) *
    weight + bias``, all in fp32, rounded once to ``x``'s dtype; returned as
    the NCHW view of an NHWC tensor."""
    v = _nhwc(x).float()
    d = v - v.mean(-1, keepdim=True)
    var = (d * d).mean(-1, keepdim=True)
    n = d * torch.rsqrt(var + eps) * _param(weight, x.dtype).float() + _param(bias, x.dtype).float()
    return n.to(x.dtype).contiguous().permute(0, 3, 1, 2)


def residualLayerNormPlain(x, y, yBias, scale, weight, bias, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """``z = x + (y + yBias) * scale`` in fp32, each operation rounded as
    torch rounds it, ``z`` rounded once to ``x``'s dtype; then
    :func:`layerNormPlain` of that ``z``.  Returns (z, n), NCHW views of
    NHWC tensors."""
    t = x.dtype
    zf = _nhwc(x).float() + (_nhwc(y).float() + _param(yBias, t).float()) * _param(scale, t).float()
    z = zf.to(t).contiguous().permute(0, 3, 1, 2)
    return z, layerNormPlain(z, weight, bias, eps)


def _check(features, params) -> None:
    """Raise on what the kernel does not take; ``features`` and ``params``
    are (name, tensor) pairs, the first feature the norm's input."""
    x = features[0][1]
    if x.dtype not in _TYPES:
        raise TypeError(f"layerNorm takes fp32 or bf16 features, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] % C_STEP or not MIN_C <= x.shape[1] <= MAX_C:
        raise ValueError(f"layerNorm takes (N, C, H, W) with C a multiple of {C_STEP} in [{MIN_C}, {MAX_C}], "
                         f"got {tuple(x.shape)}")
    C = x.shape[1]
    for name, t in features:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"layerNorm: {name} {t.dtype}{tuple(t.shape)}, the input {x.dtype}{tuple(x.shape)}")
        if not _nhwc(t).is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layerNorm takes channels-last contiguous, 16-byte aligned features; {name} has "
                             f"strides {t.stride()}")
    for name, p in params:
        if p.numel() != C:
            raise ValueError(f"layerNorm: {name} holds {p.numel()} values for {C} channels")
    for name, t in features + params:
        if not (t.is_cuda or t.is_meta) or t.device != x.device:
            raise ValueError(f"layerNorm runs on a CUDA device: {name} on {t.device}, the input on {x.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        lib.nhwcLayerNorm.argtypes = ([ctypes.c_int] + [ptr] * 8
                                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ptr])
        lib.nhwcLayerNorm.restype = ctypes.c_int
        lib.layerNormErrorString.argtypes = [ctypes.c_int]
        lib.layerNormErrorString.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(x, weight, bias, eps, residual=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K8 launch; ``residual`` (y, yBias, scale) selects mode (b).
    Returns (z or None, n), NCHW views of NHWC tensors."""
    dtype = x.dtype
    params = [("weight", _param(weight, dtype)), ("bias", _param(bias, dtype))]
    features = [("x", x)]
    if residual is not None:
        y, yBias, scale = residual
        features.append(("y", y))
        params += [("yBias", _param(yBias, dtype)), ("scale", _param(scale, dtype))]
    _check(features, params)
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in features + params):
        raise RuntimeError("layerNorm's kernel has no backward: run it under torch.no_grad() or "
                           "torch.inference_mode(), or train on the plain versions (NAFNet's fused = False)")
    if x.is_meta:
        return residualLayerNormPlain(x, *residual, weight, bias, eps) if residual else \
            (None, layerNormPlain(x, weight, bias, eps))
    N, C, H, W = x.shape
    out = torch.empty((N, H, W, C), dtype=dtype, device=x.device)
    z = torch.empty_like(out) if residual is not None else None
    p = {name: t.data_ptr() for name, t in params}
    lib = _library()
    with torch.cuda.device(x.device):  # the launch goes to the tensors' card, on its stream
        err = lib.nhwcLayerNorm(_TYPES[dtype], x.data_ptr(), residual[0].data_ptr() if residual else None,
                                p.get("yBias"), p.get("scale"), p["weight"], p["bias"],
                                z.data_ptr() if z is not None else None, out.data_ptr(), N * H * W, C, float(eps),
                                torch.cuda.get_device_properties(x.device).multi_processor_count,
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nhwcLayerNorm launch failed: {lib.layerNormErrorString(err).decode()}")
    layerNorm.launches += 1
    return (z.permute(0, 3, 1, 2) if z is not None else None), out.permute(0, 3, 1, 2)


def layerNorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Mode (a): the norm of ``x`` (N, C, H, W) over its channels, in
    ``x``'s dtype; ``weight`` and ``bias`` hold C values.  CPU tensors take
    :func:`layerNormPlain`; otherwise one K8 launch, or a raise.
    ``layerNorm.launches`` counts the launches of both modes."""
    if x.device.type == "cpu" and weight.device.type == "cpu" and bias.device.type == "cpu":
        return layerNormPlain(x, weight, bias, eps)
    return _launch(x, weight, bias, eps)[1]


def residualLayerNorm(x, y, yBias, scale, weight, bias, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode (b): ``z = x + (y + yBias) * scale`` rounded once to ``x``'s
    dtype, and the norm of that ``z``; returns (z, n).  ``x`` and ``y`` are
    (N, C, H, W), the other four hold C values.  CPU tensors take
    :func:`residualLayerNormPlain`; otherwise one K8 launch, or a raise."""
    if all(t.device.type == "cpu" for t in (x, y, yBias, scale, weight, bias)):
        return residualLayerNormPlain(x, y, yBias, scale, weight, bias, eps)
    return _launch(x, weight, bias, eps, (y, yBias, scale))


layerNorm.launches = 0
