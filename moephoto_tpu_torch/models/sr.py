"""Y-channel SR and denoise families as ``nn.Module``s: MoeNet_lite2
(reference ``MoeNet_lite2.py``), MyNet (``Net2x/3x/4x``), ``NetDN`` and
``SEDN`` (reference ``models.py``), state-dict keys as the checkpoints'.

All operate on single-channel planes, NHWC (B, H, W, planes); the executor
folds RGB channels into the batch.  With ``pack`` > 1 the lite module holds
block-diagonal weights (:func:`models.api.packBlockDiag`) and ``pack``
planes ride the channel axis.

MyNet's up paths are conv 3x3 -> pixel shuffle -> PReLU as the reference
writes them; the JAX package's deferred sub-pixel form with permuted
weights is the same function laid out for the TPU's matrix unit.  SEDN's
block scales the features by the SE gate and then applies the 1x1
``trans`` conv; the JAX package folds the gate into a per-image ``trans``
weight, the same product in another order.

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
import torch.nn.functional as F
from torch import nn

from moephoto_tpu_torch.models.api import interleaveNested, prelu
from moephoto_tpu_torch.models.blocks import ARSB, FRM, UpsampleBlock
from moephoto_tpu_torch.ops.fusedup import PrepCache, fusedUpHeads, prepare

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
        # the fused kernel's inputs, prepared once per (dtype, device): see upWeights
        self._upCache = PrepCache()

    def upWeights(self, dtype, device):
        """What :func:`fusedUpHeads` reads, made from this module's up
        stages and heads once for rows of ``dtype`` on ``device`` and kept
        on the module; ``load_state_dict``, ``to`` and any in-place write
        to one of those parameters make the next call build it anew."""
        params = {k: v for k, v in self.named_parameters() if k.startswith(("ures.", "uim.", "convt_R1", "convt_I1"))}
        return self._upCache.get((dtype, torch.device(device)), list(params.values()),
                                 lambda: prepare(params, self.nUps, dtype, device))

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
            flat = fusedUpHeads(
                self.upWeights(res.dtype, res.device), res.reshape(-1, c), im.reshape(-1, c), self.nUps
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


class MyNet(nn.Module):
    """The MyNet trunk with its two heads: conv_input -> PReLU gives
    ``out``; conv_input2 and six ARSBs give ``f``; the result is
    ``u(out) + convt_R1(f)``.  (B, H, W, 1) -> (B, H s, W s, 1).  The 3x3
    convs carry no bias; the up blocks' convs do."""

    N_BLOCKS = 6

    def __init__(self, nf: int, u: nn.Module, convt_R1: nn.Module):
        super().__init__()
        self.conv_input = nn.Conv2d(1, nf, 3, padding=1, bias=False)
        self.relu = nn.PReLU()
        self.conv_input2 = nn.Conv2d(nf, nf, 3, padding=1, bias=False)
        for i in range(self.N_BLOCKS):
            setattr(self, f"convt_F{i + 1}", ARSB(nf))
        self.u = u
        self.convt_R1 = convt_R1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        out = prelu(self.conv_input(x), self.relu.weight)
        f = self.conv_input2(out)
        for i in range(self.N_BLOCKS):
            f = getattr(self, f"convt_F{i + 1}")(f)
        return (self.u(out) + self.convt_R1(f)).permute(0, 2, 3, 1)


class MyNetSR(MyNet):
    """``Net2x``/``Net3x``/``Net4x`` (a2..a4, p2..p4): 64 channels, each
    head ``nUps`` up blocks of ratio ``r`` (keys ``{head}.{i}.0/2``) and a
    3x3 conv to one channel (key ``{head}.{nUps}``)."""

    NF = 64
    UPS = {2: (1, 2), 3: (1, 3), 4: (2, 2)}  # scale -> (nUps, r)

    def __init__(self, scale: int):
        if scale not in self.UPS:
            raise ValueError(f"MyNet scale {scale} not in (2, 3, 4)")
        nUps, r = self.UPS[scale]
        head = lambda: nn.Sequential(*[UpsampleBlock(self.NF, r) for _ in range(nUps)],
                                     nn.Conv2d(self.NF, 1, 3, padding=1, bias=False))
        super().__init__(self.NF, head(), head())


class NetDN(MyNet):
    """Light denoise (lite5/10/15): the 48-channel trunk with plain 3x3
    conv heads."""

    NF = 48

    def __init__(self):
        head = lambda: nn.Conv2d(self.NF, 1, 3, padding=1, bias=False)
        super().__init__(self.NF, head(), head())


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class SEBlock(nn.Module):
    """SEDN's SE residual conv block (reference ``_Conv_Block``): three 3x3
    convs, 64 -> 128 -> 256 -> 256, with LeakyReLU(0.2) between them, a
    squeeze-excitation gate (global mean -> ``conv_down`` to 16 ->
    LeakyReLU -> ``conv_up`` -> sigmoid, all in fp32), the gated features
    through the 1x1 ``trans`` conv back to 64 and a LeakyReLU, plus the
    input.  No conv carries a bias.  Runs on NCHW."""

    NF, WIDTHS, SQUEEZE = 64, (128, 256, 256), 16

    def __init__(self):
        super().__init__()
        a, b, c = self.WIDTHS
        act = lambda: nn.LeakyReLU(0.2)
        self.rblock = nn.Sequential(_conv3(self.NF, a), act(), _conv3(a, b), act(), _conv3(b, c))
        self.conv_down = nn.Conv2d(c, self.SQUEEZE, 1, bias=False)
        self.conv_up = nn.Conv2d(self.SQUEEZE, c, 1, bias=False)
        self.trans = nn.Sequential(nn.Conv2d(c, self.NF, 1, bias=False), act())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rblock(x)
        se = out.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
        se = F.conv2d(F.leaky_relu(F.conv2d(se, self.conv_down.weight.float()), 0.2), self.conv_up.weight.float())
        return x + self.trans(out * torch.sigmoid(se).to(out.dtype))


class SEDN(nn.Module):
    """Strong denoise (15/25/50): conv_input -> LeakyReLU, 16 SE residual
    blocks (keys ``convt_F1.{i}``), a 3x3 conv to one channel, plus the
    input.  (B, H, W, 1) -> (B, H, W, 1)."""

    N_BLOCKS = 16

    def __init__(self):
        super().__init__()
        self.conv_input = _conv3(1, SEBlock.NF)
        self.convt_F1 = nn.Sequential(*[SEBlock() for _ in range(self.N_BLOCKS)])
        self.convt_R1 = _conv3(SEBlock.NF, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        f = self.convt_F1(F.leaky_relu(self.conv_input(x), 0.2))
        return (x + self.convt_R1(f)).permute(0, 2, 3, 1)


net2x = functools.partial(MyNetSR, 2)
net3x = functools.partial(MyNetSR, 3)
net4x = functools.partial(MyNetSR, 4)
netDN = NetDN
sedn = SEDN
