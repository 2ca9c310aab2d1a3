"""Convolutions whose inputs and weights pass through a quantiser.

The references run in fp32 with the quantiser off.  The control of the
correctness check runs the same modules with :func:`fp8` on, the
precision below the bf16 that the configurations state.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round ``t`` through float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to the format's largest value), as fp8
    inference scales a tensor; the result is in ``t``'s dtype."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class QConv2d(nn.Conv2d):
    quant: Optional[Callable] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant or (lambda t: t)
        return self._conv_forward(q(x), q(self.weight), self.bias)


class QConvTranspose2d(nn.ConvTranspose2d):
    quant: Optional[Callable] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant or (lambda t: t)
        return F.conv_transpose2d(q(x), q(self.weight), self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def setQuant(model: nn.Module, quant: Optional[Callable]) -> nn.Module:
    """Give every convolution of ``model`` the quantiser ``quant`` (None:
    plain fp32)."""
    for m in model.modules():
        if isinstance(m, (QConv2d, QConvTranspose2d)):
            m.quant = quant
    return model


def fp32Exact():
    """Context that turns TF32 off for convolutions and products, so an
    fp32 reference computes in fp32 on the card."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cuda.matmul.allow_tf32 = mm

    return ctx()
