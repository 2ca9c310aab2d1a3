"""MoeNet_lite2 (reference ``MoeNet_lite2.py``) as an ``nn.Module``.

Operates on single-channel planes, NHWC (B, H, W, planes); the executor
folds RGB channels into the batch.  With ``pack`` > 1 the module holds
block-diagonal weights (:func:`models.api.packBlockDiag`) and ``pack``
planes ride the channel axis.

Everything after the first pixel shuffle in the reference is pointwise,
so sub-pixel offsets are carried as nested trailing axes
(b, h, w, 2, 2, ..., c) and interleaved once on the output
(``interleaveNested``).  The fused path runs that whole up path and both
heads in one kernel (:func:`ops.fusedup.fusedUpHeads`), on the card
through the CUDA kernel and on the CPU through its plain version.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from moephoto_tpu_torch.models.api import interleaveNested, prelu
from moephoto_tpu_torch.models.blocks import FRM
from moephoto_tpu_torch.ops.fusedup import fusedUpHeads

NF, SE_HIDDEN = 48, 3


class LB(nn.Module):
    """MoeNet_lite2 LB block: conv -> PReLU -> conv -> FRM, + skip."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.relu = nn.PReLU()
        self.conv_2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.se = FRM(c, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        out = self.conv_2(prelu(self.conv_1(x), self.relu.weight))
        return self.se(out) + x


def _upStageModule(c: int) -> nn.Sequential:
    # keys .0 (1x1 conv to 4c) and .2 (PReLU) as the checkpoint's
    # conv -> PixelShuffle -> PReLU sequence
    return nn.Sequential(nn.Conv2d(c, 4 * c, 1, bias=True), nn.PixelShuffle(2), nn.PReLU())


class MoeNetLite2(nn.Module):
    """MoeNet_lite2 for ``upscale`` in (2, 4, 8): (B, H, W, pack) ->
    (B, H*upscale, W*upscale, pack).

    ``fused`` selects the one-kernel up path; ``fused=False`` runs the
    plain per-stage path (``upStage``/``pointwise``), kept as the
    reference the fused path is held against.
    """

    def __init__(self, upscale: int = 2, pack: int = 1, fused: bool = True):
        super().__init__()
        if upscale not in (2, 4, 8):
            raise ValueError(f"MoeNet_lite2 upscale {upscale} not in (2, 4, 8)")
        self.nUps = int(upscale).bit_length() - 1
        self.fused = fused
        c, hidden = NF * pack, SE_HIDDEN * pack
        self.conv_input = nn.Conv2d(pack, c, 1, bias=False)
        self.relu = nn.PReLU()
        self.conv_input2 = nn.Conv2d(c, c, 1, bias=False)
        self.convt_F11 = LB(c, hidden)
        self.convt_F12 = LB(c, hidden)
        self.convt_F13 = LB(c, hidden)
        self.ures = nn.Sequential(*[_upStageModule(c) for _ in range(self.nUps)])
        self.uim = nn.Sequential(*[_upStageModule(c) for _ in range(self.nUps)])
        self.convt_R1 = nn.Conv2d(c, pack, 1, bias=False)
        self.convt_I1 = nn.Conv2d(c, pack, 1, bias=False)

    @staticmethod
    def _upStage(stage: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """x: (b, h, w, <subpos...>, c) -> same + a trailing (2, 2) pair;
        one product with the weight's output columns ordered (row, col, co)."""
        c = x.shape[-1]
        w = stage[0].weight[:, :, 0, 0]  # (4c, c): rows co*4 + a*2 + b
        wp = w.reshape(c, 2, 2, c).permute(3, 1, 2, 0).reshape(c, 4 * c)  # cols (a, b, co)
        bp = stage[0].bias.reshape(c, 2, 2).permute(1, 2, 0).reshape(-1)
        y = torch.matmul(x.float(), wp.to(x.dtype).float()) + bp.float()
        y = y.to(x.dtype).reshape(x.shape[:-1] + (2, 2, c))
        return prelu(y, stage[2].weight, dim=-1)

    @staticmethod
    def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.float(), conv.weight[:, :, 0, 0].t().to(x.dtype).float())
        if conv.bias is not None:
            y = y + conv.bias.float()
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view with channels-last strides
        out = prelu(self.conv_input(x), self.relu.weight)
        out = out.contiguous(memory_format=torch.channels_last)
        f = self.convt_F11(self.conv_input2(out))
        res = self.convt_F13(self.convt_F12(f))
        im = out
        b, c, h, w = res.shape
        res = res.permute(0, 2, 3, 1)  # NHWC again
        im = im.permute(0, 2, 3, 1)
        if self.fused:
            params = dict(self.named_parameters())
            flat = fusedUpHeads(
                params, res.reshape(-1, c), im.reshape(-1, c), self.nUps
            )
            hr = flat.reshape((b, h, w) + (2, 2) * self.nUps + (-1,))
            return interleaveNested(hr, self.nUps)
        for i in range(self.nUps):
            res = self._upStage(self.ures[i], res)
            im = self._upStage(self.uim[i], im)
        hr = self._pointwise(self.convt_R1, res) + self._pointwise(self.convt_I1, im)
        return interleaveNested(hr, self.nUps)


moeNetLite2x2 = functools.partial(MoeNetLite2, 2)
moeNetLite2x4 = functools.partial(MoeNetLite2, 4)
moeNetLite2x8 = functools.partial(MoeNetLite2, 8)
