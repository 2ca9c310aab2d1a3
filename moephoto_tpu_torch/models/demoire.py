"""Demoire models: sun_demoire, moire_obj and moire_screen_gan (reference
``python/sun_demoire.py``, ``moire_obj.py``, ``moire_screen_gan.py``; JAX
``models/demoire.py``), as ``nn.Module``s with the checkpoints' keys.

No source in reach fixes moire_obj's and moire_screen_gan's widths, so
each takes one feature width ``c`` (default 64, an assumption) and the
inner widths follow the JAX functions' arithmetic: a CAT halves 2c -> c, an
upsample block maps c -> 4c and shuffles back to c, the non-local blocks'
inner width defaults to c / 2.  Convs carry biases and the FRMs reduce by
``FRM_REDUCTION``; ``load_state_dict(strict=True)`` will confirm or refute
all of this against a checkpoint.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from moephoto_tpu_torch.models.api import ScaleLayer, prelu
from moephoto_tpu_torch.models.blocks import CARB, FRM, UpsampleBlock

# (cin, cm, cout) of each Down; stride 2 where cin == cm
SUN_DOWNS = ((3, 32, 32), (32, 32, 64), (64, 64, 64), (64, 64, 64), (64, 64, 64))


class Down(nn.Module):
    """conv 3x3 (stride 2 iff cin == cm) -> PReLU -> conv 3x3."""

    def __init__(self, cin: int, cm: int, cout: int):
        super().__init__()
        self.down = nn.Conv2d(cin, cm, 3, stride=2 if cin == cm else 1, padding=1)
        self.relu = nn.PReLU()
        self.convt_R1 = nn.Conv2d(cm, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convt_R1(prelu(self.down(x), self.relu.weight))


def _branch(level: int, c: int) -> nn.Sequential:
    """Level 0: conv 3x3 to RGB -> PReLU.  Level i > 0: i pairs of
    (ConvTranspose 4/2/1, PReLU), then conv 3x3 to RGB."""
    if level == 0:
        return nn.Sequential(nn.Conv2d(c, 3, 3, padding=1), nn.PReLU())
    layers = []
    for _ in range(level):
        layers += [nn.ConvTranspose2d(c, c, 4, stride=2, padding=1), nn.PReLU()]
    return nn.Sequential(*layers, nn.Conv2d(c, 3, 3, padding=1))


class SunDemoire(nn.Module):
    """5-scale downsample with one up branch per scale, summed:
    (B, H, W, 3) -> (B, H, W, 3); H and W multiples of 16.  Keys
    ``downs.{i}.{down,relu,convt_R1}`` and ``branches.{i}.{j}``; the
    ConvTranspose weights are (64, 64, 4, 4), the only 4x4 kernels
    (``registry._sunConvT``)."""

    def __init__(self):
        super().__init__()
        self.downs = nn.ModuleList([Down(*cfg) for cfg in SUN_DOWNS])
        self.branches = nn.ModuleList([_branch(i, cfg[2]) for i, cfg in enumerate(SUN_DOWNS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        total = None
        for down, branch in zip(self.downs, self.branches):
            feat = down(feat)
            b = feat
            for layer in branch:
                b = prelu(b, layer.weight) if isinstance(layer, nn.PReLU) else layer(b)
            total = b if total is None else total + b
        return total.permute(0, 2, 3, 1)


sunDemoire = SunDemoire


# ---------------------------------------------------------------------------
# moire_obj and moire_screen_gan
# ---------------------------------------------------------------------------

FRM_REDUCTION = 16


def _carb(c: int) -> CARB:
    return CARB(c, max(1, c // FRM_REDUCTION))


def _frm(c: int) -> FRM:
    return FRM(c, max(1, c // FRM_REDUCTION))


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over all positions, with no 1/sqrt(d) scale: q, k
    (B, N, d), v (B, N, dv) -> (B, N, dv) in q's dtype.  Both products
    accumulate in fp32 and the softmax runs in fp32; its weights are rounded
    to the input dtype before the second product, as the JAX einsums with
    ``preferred_element_type=float32``."""
    att = torch.softmax(torch.bmm(q.float(), k.float().mT), -1).to(q.dtype)
    return torch.bmm(att.float(), v.float()).to(q.dtype)


def _positions(t: torch.Tensor) -> torch.Tensor:
    return t.flatten(2).mT  # NCHW -> (B, H W, C), positions row-major


class SpaceAttention(nn.Module):
    """Full softmax attention over the h w positions with K as the query
    side, softmax(K Q^T) V, through the 1x1 ``local_weight`` conv, plus the
    input (JAX ``_spaceAttention``).  K, Q and V are 1x1 convs c -> c."""

    def __init__(self, c: int):
        super().__init__()
        self.K = nn.Conv2d(c, c, 1)
        self.Q = nn.Conv2d(c, c, 1)
        self.V = nn.Conv2d(c, c, 1)
        self.local_weight = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = attend(_positions(self.K(x)), _positions(self.Q(x)), _positions(self.V(x)))
        return x + self.local_weight(o.mT.unflatten(2, x.shape[2:]))


class RK3(nn.Module):
    """Runge-Kutta-3 block (JAX ``_rk3``): three PReLU -> conv 3x3 steps
    (``ms.{i}.0/1``) combined through five learned scalars (``scale.{i}``)."""

    def __init__(self, c: int):
        super().__init__()
        self.ms = nn.ModuleList([nn.Sequential(nn.PReLU(), _conv3(c, c)) for _ in range(3)])
        self.scale = nn.ModuleList([ScaleLayer() for _ in range(5)])

    def _trans(self, i: int, v: torch.Tensor) -> torch.Tensor:
        return self.ms[i][1](prelu(v, self.ms[i][0].weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.scale
        k1 = self._trans(0, x)
        k2 = self._trans(1, sc[0](k1) + x)
        k3 = self._trans(2, sc[1](k2) + sc[2](k1) + x)
        return sc[3](k2) + sc[4](k3 + k1) + x


class CAT(nn.Sequential):
    """FRM at 2c, then a 1x1 conv 2c -> c (keys ``0``, ``1``)."""

    def __init__(self, c: int):
        super().__init__(_frm(2 * c), nn.Conv2d(2 * c, c, 1))


class ConvPReLU(nn.Module):
    """conv 3x3 -> PReLU, keys ``conv_input``, ``relu``."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv_input = _conv3(cin, c)
        self.relu = nn.PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(self.conv_input(x), self.relu.weight)


class Down2(ConvPReLU):
    """conv 3x3 -> PReLU -> stride-2 conv -> conv (``down``, ``convt_R1``),
    then a CARB (``block``) for moire_obj; moire_screen_gan's has none."""

    def __init__(self, cin: int, c: int, block: bool):
        super().__init__(cin, c)
        self.down = _conv3(c, c, 2)
        self.convt_R1 = _conv3(c, c)
        self.block = _carb(c) if block else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(self.convt_R1(self.down(super().forward(x))))


_OBJ_STAGES = {"sa": SpaceAttention, "carb": _carb, "rk3": RK3}


class ObjBranch(nn.Module):
    """moire_obj's Branch (JAX ``_objBranch``): ``inputF``; with ``cat``,
    five CARBs (``shallowF``) whose result is concatenated with the inner
    level's output and halved by a CAT, the first ``deepF`` stage; the
    ``deep`` stages; with ``combine``, the input features added, a space
    attention and a x2 upsample block (``combineF.SA2``, ``combineF.u1``)."""

    def __init__(self, cin: int, c: int, deep: Sequence[str], cat: bool, combine: bool):
        super().__init__()
        self.inputF = ConvPReLU(cin, c)
        if cat:
            self.shallowF = nn.Sequential(*[_carb(c) for _ in range(5)])
        self.deepF = nn.Sequential(*([CAT(c)] if cat else []), *[_OBJ_STAGES[k](c) for k in deep])
        if combine:
            self.combineF = nn.ModuleDict({"SA2": SpaceAttention(c), "u1": UpsampleBlock(c, 2)})

    def forward(self, x: torch.Tensor, inner: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.inputF(x)
        y = self.deepF(out if inner is None else torch.cat([self.shallowF(out), inner], 1))
        if hasattr(self, "combineF"):
            return self.combineF["u1"](self.combineF["SA2"](out + y))
        return y


class CleanHead(nn.Module):
    """moire_obj's ``to_clean1``: a residual (conv 3x3 ``gff`` -> PReLU ->
    FRM ``se``, keys ``residual.0.*``), ``conv_tail`` -> PReLU ``relut`` ->
    ``conv_out`` to RGB."""

    def __init__(self, c: int):
        super().__init__()
        self.residual = nn.ModuleList([nn.ModuleDict({"gff": _conv3(c, c), "relu": nn.PReLU(), "se": _frm(c)})])
        self.conv_tail = _conv3(c, c)
        self.relut = nn.PReLU()
        self.conv_out = _conv3(c, 3)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        r = self.residual[0]
        y = y + r["se"](prelu(r["gff"](y), r["relu"].weight))
        return self.conv_out(prelu(self.conv_tail(y), self.relut.weight))


class MoireObj(nn.Module):
    """Nested-UNet demoire (JAX ``moireObj``), (B, H, W, 3) -> (B, H, W, 3),
    H and W multiples of 4.  The outer level sits under ``U.``, the middle
    under ``U.3.``, the inner under ``U.3.3.``; the head is ``to_clean1``.
    The registry tiles it at 128 px, so its space attentions at half size
    see 4096 positions a tile."""

    def __init__(self, c: int = 64):
        super().__init__()
        carb7 = ["carb"] * 7
        inner = nn.ModuleDict({"SA3": SpaceAttention(c),
                               "branch3": ObjBranch(c, c, carb7 + ["rk3"] * 3, cat=False, combine=True)})
        middle = nn.ModuleDict({"down2_2": Down2(c, c, block=True), "SA2": SpaceAttention(c),
                                "branch2": ObjBranch(c, c, ["sa"] + carb7 + ["rk3"] * 2, cat=True, combine=True),
                                "3": inner})
        self.U = nn.ModuleDict({"down2_1": Down2(3, c, block=True),
                                "branch1": ObjBranch(3, c, carb7 + ["rk3"] * 2, cat=True, combine=False),
                                "3": middle})
        self.to_clean1 = CleanHead(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        outer = self.U
        middle = outer["3"]
        inner = middle["3"]
        x1 = outer["down2_1"](x)
        t3 = inner["branch3"](inner["SA3"](middle["down2_2"](x1)))
        t2 = middle["branch2"](middle["SA2"](x1), t3)
        return self.to_clean1(outer["branch1"](x, t2)).permute(0, 2, 3, 1)


def din(content: torch.Tensor, encode: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Dynamic instance normalisation (JAX ``_din``) on NCHW: ``content``
    normalised by its per-channel spatial mean and unbiased std (plus
    ``eps``), then given ``encode``'s; in fp32, rounded once.  A map of one
    pixel has no unbiased std (NaN), as in the reference."""
    def stats(t):
        std, mean = torch.std_mean(t.float().flatten(2), -1, keepdim=True)
        return mean[..., None], std[..., None]

    cMean, cStd = stats(content)
    eMean, eStd = stats(encode)
    return ((content.float() - cMean) / (cStd + eps) * eStd + eMean).to(content.dtype)


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block with no subsampling, no norm and no
    scale (JAX ``_nonlocalBlock``): softmax(theta phi^T) g through ``W``,
    plus the input; ``g``, ``theta``, ``phi`` c -> inter, ``W`` inter -> c."""

    def __init__(self, c: int, inter: int):
        super().__init__()
        self.g = nn.Conv2d(c, inter, 1)
        self.theta = nn.Conv2d(c, inter, 1)
        self.phi = nn.Conv2d(c, inter, 1)
        self.W = nn.Conv2d(inter, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = attend(_positions(self.theta(x)), _positions(self.phi(x)), _positions(self.g(x)))
        return self.W(y.mT.unflatten(2, x.shape[2:])) + x


class NonLocalCA(nn.Module):
    """The map cut at (h // 2, w // 2) into four quarters, each through the
    one ``non_local`` block, and put back (JAX ``_nonlocalCA``)."""

    def __init__(self, c: int, inter: int):
        super().__init__()
        self.non_local = NonLocalBlock(c, inter)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1, w1 = x.shape[2] // 2, x.shape[3] // 2
        rows = [[self.non_local(x[:, :, r, c]) for c in (slice(None, w1), slice(w1, None))]
                for r in (slice(None, h1), slice(h1, None))]
        return torch.cat([torch.cat(row, 3) for row in rows], 2)


class GanBranch(ConvPReLU):
    """moire_screen_gan's Branch (JAX ``_ganBranch``): ``conv_input`` ->
    PReLU gives ``out``; a chain of CARBs (``convt_F.{i}``) coupled through
    DIN with a chain of style convs of the given ``strides`` (``s_conv.{i}``);
    optionally ``non_local``; ``out`` added, ``nUps`` x2 upsample blocks
    (``u.{i}``) and ``convt_shape1`` to RGB."""

    def __init__(self, c: int, inter: int, strides: Sequence[int], nUps: int, nonLocal: bool):
        super().__init__(c, c)
        self.convt_F = nn.ModuleList([_carb(c) for _ in strides])
        self.s_conv = nn.ModuleList([_conv3(c, c, s) for s in strides])
        if nonLocal:
            self.non_local = NonLocalCA(c, inter)
        self.u = nn.Sequential(*[UpsampleBlock(c, 2) for _ in range(nUps)])
        self.convt_shape1 = _conv3(c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x)
        feat = style = out
        for carb, sConv in zip(self.convt_F, self.s_conv):
            style = sConv(style)
            feat = din(carb(feat), style)
        if hasattr(self, "non_local"):
            feat = self.non_local(feat)
        return self.convt_shape1(self.u(out + feat))


class GanHead(ConvPReLU):
    """moire_screen_gan's first branch: conv 3 -> c, PReLU, ``conv_input2``
    c -> 3, at full size."""

    def __init__(self, c: int):
        super().__init__(3, c)
        self.conv_input2 = _conv3(c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_input2(super().forward(x))


# branches 1.. of moire_screen_gan (JAX ``_GAN_BRANCHES``); branch i runs at 1/2^i size
GAN_BRANCHES = (
    dict(strides=(1, 2, 2), nUps=1, nonLocal=False),
    dict(strides=(1, 2, 1, 2), nUps=2, nonLocal=True),
    dict(strides=(1, 2, 1, 2, 1, 2), nUps=3, nonLocal=True),
    dict(strides=(1, 2, 1, 2, 1, 2, 1, 2), nUps=4, nonLocal=True),
    dict(strides=(1, 1, 2, 1, 1, 2, 1, 1), nUps=5, nonLocal=True),
)


class MoireScreenGan(nn.Module):
    """Multi-scale demoire (JAX ``makeMoireScreenGan``), (B, H, W, 3) ->
    (B, H, W, 3): ``layers`` branches, branch i on the input taken down i
    times by ``_down2.{i-1}`` and back up to full size, each weighted by a
    learned scalar (``scales.{i}``) and summed.  Branch 4's style chain ends
    at 1/256 of the input, so inputs under 512 px give a NaN (a variance of
    one pixel), as in the reference: the registry tiles it at 512."""

    def __init__(self, c: int = 64, inter: Optional[int] = None, layers: int = 5):
        super().__init__()
        inter = inter or c // 2
        self.branches = nn.ModuleList([GanHead(c)] + [GanBranch(c, inter, **GAN_BRANCHES[i])
                                                       for i in range(layers - 1)])
        self._down2 = nn.ModuleList([Down2(3 if i == 0 else c, c, block=False) for i in range(layers - 1)])
        self.scales = nn.ModuleList([ScaleLayer() for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat, total = x.permute(0, 3, 1, 2), None
        for i, (branch, scale) in enumerate(zip(self.branches, self.scales)):
            b = scale(branch(feat))
            total = b if total is None else total + b
            if i < len(self._down2):
                feat = self._down2[i](feat)
        return total.permute(0, 2, 3, 1)


moireObj = MoireObj
moireScreenGan = MoireScreenGan
