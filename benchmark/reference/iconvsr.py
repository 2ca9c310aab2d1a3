"""Plain IconVSR x4 video super-resolution (Chan et al., "BasicVSR: The
Search for Essential Components in Video Super-Resolution and Beyond",
CVPR 2021; github.com/XPixelGroup/BasicSR ``basicsr/archs/basicvsr_arch.py``
``IconVSR``), as opteroncx/MoePhoto ``python/videoSR.py`` runs it, NCHW, in
fp32, and the VSR video chain around it (:func:`vsrClip`).

The network (state-dict keys as MoePhoto's checkpoint, one state dict a
module):

- ``spynet``: a 6-level flow pyramid; each level warps the support frame
  by the flow of the level below, doubled in size and value, and adds the
  output of five 7x7 convs (8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU between);
- ``edvr``: information refill at keyframes, EDVR's feature extractor on a
  ``REF_TIME``-frame clip: conv_first and five residual blocks, two
  stride-2 levels, PCD alignment (three pyramid levels and a cascade, four
  modulated deformable convs with ``DG`` groups, :class:`DCNv2Pack`) and
  TSA fusion to the centre frame;
- ``backward_trunk`` and ``forward_trunk``: a 3x3 input conv and
  ``num_block`` residual blocks at 64 channels; each step takes the
  previous step's features warped by the flow between the two frames;
  ``backward_fusion`` and ``forward_fusion`` fuse the refill at keyframes;
  the forward trunk also takes the backward features (coupled
  propagation);
- ``upsample``: conv, pixel shuffle x2, conv, pixel shuffle x2, two convs
  (keys 0, 3, 6, 8), plus the frame's bilinear x4.

Departures from BasicSR's ``IconVSR``, each MoePhoto's and each pinned by a
test against the program (``tests/test_torch_vsr_reference.py``):

- the schedule: keyframes every ``KEY_STRIDE`` = 7 frames (BasicSR: 5)
  and at the last frame of each batch the stream's keyframe stage takes
  (:func:`isKeyframe`: each backward chunk's last frame, and at the end of
  the stream n - 4, unless a chunk ended there, and n - 1); EDVR takes a
  ``REF_TIME`` = 7-frame window (BasicSR: 5) whose ends are filled by
  MoePhoto's stream padding (:func:`edvrWindow`: the three frames before
  the first are frames 6, 5, 4; the three after the last, n - 5, n - 6,
  n - 7), not by reflection;
- the backward recurrence restarts from zeros every ``BACKWARD_CHUNK`` = 20
  frames (bounded lookahead; BasicSR runs the whole sequence); the forward
  state crosses chunks, as in BasicSR;
- the warp (:func:`backWarp`) normalises grid + flow by W and H and
  samples with corners aligned, so it samples at (x + u)(W - 1)/W, not at
  x + u as BasicSR's ``flow_warp``; SpyNet runs on the frames padded to
  ``ALIGN`` = 64 rows and columns, not resized to multiples of 32.

The deformable convolution is sampled bilinearly (a corner outside the
frame reads zero) and contracted by one strided convolution, in row
blocks, so that a 7-frame clip at 576 x 960 fits.  Every convolution, the
contraction included, is a :class:`layers.QConv2d`, so the control can
quantise it.

The chain (:func:`vsrClip`): 16-bit BGR frames -> RGB in [0, 1) (value /
65536), padded by reflection to multiples of 64, the network over the
clip as MoePhoto's stream runs it, the x4 output cropped to the frame's own
size x 4, back to BGR and quantised to 16 bits as the output step does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ifrnet import frameFromBytes, toBytes16
from benchmark.reference.layers import QConv2d, fp32Exact

NUM_FEAT, NUM_BLOCK, DG, SPY_LEVELS, SCALE = 64, 30, 8, 6, 4
REF_TIME, KEY_STRIDE, BACKWARD_CHUNK, ALIGN = 7, 7, 20, 64
MODULES = ("spynet", "edvr", "backward_trunk", "forward_trunk", "backward_fusion", "forward_fusion", "upsample")
SAMPLED_VALUES = 1 << 27  # the DCN's sampled values held at a time (512 MB in fp32)

_SPY_MEAN = (0.485, 0.456, 0.406)
_SPY_STD = (0.229, 0.224, 0.225)


def conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> QConv2d:
    return QConv2d(cin, cout, k, stride, k // 2)


def lrelu(x):
    return F.leaky_relu(x, 0.1)


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


def backWarp(img, flow, padding: str):
    """MoePhoto's ``backWarp``: grid + flow normalised by the width and the
    height, sampled bilinearly with corners aligned."""
    _, _, h, w = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    gx = 2.0 * ((xs + flow[:, 0]) / w - 0.5)
    gy = 2.0 * ((ys + flow[:, 1]) / h - 0.5)
    return F.grid_sample(img, torch.stack([gx, gy], -1), mode="bilinear", padding_mode=padding, align_corners=True)


class SpyNet(nn.Module):
    def __init__(self):
        super().__init__()
        cs = (8, 32, 64, 32, 16, 2)
        layers = lambda: [m for i in range(5) for m in (conv(cs[i], cs[i + 1], 7), nn.ReLU())][:-1]
        self.basic_module = nn.ModuleList(nn.Sequential(*layers()) for _ in range(SPY_LEVELS))

    def forward(self, ref, supp):
        """The flow (B, 2, H, W) that warps ``supp`` onto ``ref`` (both (B, 3, H,
        W) RGB, H and W multiples of 32); channel 0 the x offset."""
        mean = torch.tensor(_SPY_MEAN, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(_SPY_STD, device=ref.device).view(1, 3, 1, 1)
        refs, supps = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(SPY_LEVELS - 1):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2, count_include_pad=False))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2, count_include_pad=False))
        b, _, h0, w0 = refs[0].shape
        flow = ref.new_zeros((b, 2, h0 // 2, w0 // 2))
        for level in range(SPY_LEVELS):
            r, s = refs[level], supps[level]
            up = F.interpolate(flow, size=r.shape[2:], mode="bilinear", align_corners=True) * 2.0
            flow = self.basic_module[level](torch.cat([r, backWarp(s, up, "border"), up], 1)) + up
        return flow


class ResidualBlockNoBN(nn.Module):
    def __init__(self, c: int = NUM_FEAT):
        super().__init__()
        self.conv1, self.conv2 = conv(c, c), conv(c, c)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ConvResidualBlocks(nn.Sequential):
    """Keys ``0.*`` (the input conv) and ``2.{i}.conv1/conv2``."""

    def __init__(self, cin: int, c: int = NUM_FEAT, numBlocks: int = NUM_BLOCK):
        super().__init__(conv(cin, c), nn.LeakyReLU(0.1),
                         nn.Sequential(*[ResidualBlockNoBN(c) for _ in range(numBlocks)]))


class DCNv2Pack(QConv2d):
    """Modulated deformable 3x3 conv (DCNv2) whose offsets and mask
    ``conv_offset`` predicts from a second input: its 3 dg 9 outputs are
    the offsets (the first 2 dg 9, (dy, dx) for each group and tap) and
    the mask's logits.  For output pixel p, tap k and input channel c of
    group g:

        out[p] = bias + sum_k sum_c W[:, c, k] m[g, k] bilinear(x[c], p + p_k + delta[g, k])

    The modulated samples of each pixel's nine taps are laid out as a 3x3
    block of a (3H, 3W) map and contracted by this module's own weight as a
    3x3 convolution of stride 3."""

    def __init__(self, c: int = NUM_FEAT, cout: int = NUM_FEAT, dg: int = DG):
        super().__init__(c, cout, 3, 3, 0)
        self.dg = dg
        self.conv_offset = conv(c, dg * 27)

    def columns(self, x, offset, mask, row0: int):
        """(B, C, 3R, 3W): the modulated samples for the output rows [row0,
        row0 + R) of ``offset`` (B, 2 dg 9, R, W) and ``mask`` (B, dg 9, R, W)."""
        b, c, h, w = x.shape
        dg, rows = self.dg, offset.shape[2]
        cg = c // dg
        dev = x.device
        off = offset.reshape(b, dg, 9, 2, rows, w)
        ky = torch.arange(9, device=dev).div(3, rounding_mode="floor").view(1, 1, 9, 1, 1) - 1.0
        kx = torch.arange(9, device=dev).remainder(3).view(1, 1, 9, 1, 1) - 1.0
        py = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev).view(1, 1, 1, rows, 1)
        px = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, 1, 1, w)
        sy, sx = py + ky + off[:, :, :, 0], px + kx + off[:, :, :, 1]  # (b, dg, 9, R, W)
        y0, x0 = torch.floor(sy.clamp(-2.0, h + 1.0)), torch.floor(sx.clamp(-2.0, w + 1.0))
        wy, wx = sy - y0, sx - x0
        table = x.reshape(b, dg, cg, h * w)
        val = 0.0
        for dy, dx, weight in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx), (1, 0, wy * (1 - wx)),
                               (1, 1, wy * wx)):
            yi, xi = (y0 + dy).long(), (x0 + dx).long()
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, dg, 1, -1).expand(b, dg, cg, -1)
            v = torch.gather(table, 3, idx).reshape(b, dg, cg, 9, rows, w)
            val = val + v * (weight * inside)[:, :, None]
        val = val * mask.reshape(b, dg, 1, 9, rows, w)
        # (b, c, ky, kx, R, W) -> (b, c, R, ky, W, kx)
        return val.reshape(b, c, 3, 3, rows, w).permute(0, 1, 4, 2, 5, 3).reshape(b, c, 3 * rows, 3 * w)

    def forward(self, x, feat):
        out = self.conv_offset(feat)
        n = 2 * self.dg * 9
        offset, mask = out[:, :n], torch.sigmoid(out[:, n:])
        b, c, h, w = x.shape
        block = max(1, SAMPLED_VALUES // (b * c * 9 * w))
        return torch.cat([super(DCNv2Pack, self).forward(self.columns(x, offset[:, :, a : a + block],
                                                                      mask[:, :, a : a + block], a))
                          for a in range(0, h, block)], 2)


class PCDAlignment(nn.Module):
    def __init__(self, c: int = NUM_FEAT, dg: int = DG):
        super().__init__()
        levels = ("l3", "l2", "l1")
        self.offset_conv1 = nn.ModuleDict({lv: conv(2 * c, c) for lv in levels})
        self.offset_conv2 = nn.ModuleDict({lv: conv(c if lv == "l3" else 2 * c, c) for lv in levels})
        self.offset_conv3 = nn.ModuleDict({lv: conv(c, c) for lv in levels[1:]})
        self.dcn_pack = nn.ModuleDict({lv: DCNv2Pack(c, c, dg) for lv in levels})
        self.feat_conv = nn.ModuleDict({lv: conv(2 * c, c) for lv in levels[1:]})
        self.cas_offset_conv1 = conv(2 * c, c)
        self.cas_offset_conv2 = conv(c, c)
        self.cas_dcnpack = DCNv2Pack(c, c, dg)

    def forward(self, nbr: List, ref: List):
        """The three levels of the neighbours and of the centre frame
        (full resolution first) -> the aligned neighbours."""
        upOffset = upFeat = feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            offset = lrelu(self.offset_conv1[lv](torch.cat([nbr[i - 1], ref[i - 1]], 1)))
            if i == 3:
                offset = lrelu(self.offset_conv2[lv](offset))
            else:
                offset = lrelu(self.offset_conv2[lv](torch.cat([offset, upOffset], 1)))
                offset = lrelu(self.offset_conv3[lv](offset))
            feat = self.dcn_pack[lv](nbr[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[lv](torch.cat([feat, upFeat], 1))
            if i > 1:
                feat = lrelu(feat)
                upOffset, upFeat = up2(offset) * 2.0, up2(feat)
        offset = torch.cat([feat, ref[0]], 1)
        offset = lrelu(self.cas_offset_conv2(lrelu(self.cas_offset_conv1(offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    def __init__(self, c: int = NUM_FEAT, nFrames: int = REF_TIME):
        super().__init__()
        self.temporal_attn1, self.temporal_attn2 = conv(c, c), conv(c, c)
        self.feat_fusion = conv(nFrames * c, c, 1)
        self.spatial_attn1 = conv(nFrames * c, c, 1)
        self.spatial_attn2 = conv(2 * c, c, 1)
        self.spatial_attn3 = conv(c, c)
        self.spatial_attn4 = conv(c, c, 1)
        self.spatial_attn5 = conv(c, c)
        self.spatial_attn_l1 = conv(c, c, 1)
        self.spatial_attn_l2 = conv(2 * c, c)
        self.spatial_attn_l3 = conv(c, c)
        self.spatial_attn_add1 = conv(c, c, 1)
        self.spatial_attn_add2 = conv(c, c, 1)

    def forward(self, aligned):
        """(B, N, C, H, W), H and W multiples of 4 -> (B, C, H, W)."""
        b, n, c, h, w = aligned.shape
        embRef = self.temporal_attn1(aligned[:, n // 2])
        emb = self.temporal_attn2(aligned.reshape(b * n, c, h, w)).reshape(b, n, -1, h, w)
        corr = torch.sigmoid((emb * embRef[:, None]).sum(2))  # (b, n, h, w)
        flat = (aligned * corr[:, :, None]).reshape(b, n * c, h, w)
        pool = lambda t: torch.cat([F.max_pool2d(t, 3, 2, 1), F.avg_pool2d(t, 3, 2, 1)], 1)
        feat = lrelu(self.feat_fusion(flat))
        attn = lrelu(self.spatial_attn1(flat))
        attn = lrelu(self.spatial_attn2(pool(attn)))
        level = lrelu(self.spatial_attn_l1(attn))
        level = lrelu(self.spatial_attn_l2(pool(level)))
        level = up2(lrelu(self.spatial_attn_l3(level)))
        attn = lrelu(self.spatial_attn3(attn)) + level
        attn = self.spatial_attn5(up2(lrelu(self.spatial_attn4(attn))))
        attnAdd = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attnAdd


class EDVR(nn.Module):
    def __init__(self, c: int = NUM_FEAT, nFrames: int = REF_TIME):
        super().__init__()
        self.conv_first = conv(3, c)
        self.feature_extraction = nn.Sequential(*[ResidualBlockNoBN(c) for _ in range(5)])
        self.conv_l2_1, self.conv_l2_2 = conv(c, c, 3, 2), conv(c, c)
        self.conv_l3_1, self.conv_l3_2 = conv(c, c, 3, 2), conv(c, c)
        self.pcd_align = PCDAlignment(c)
        self.fusion = TSAFusion(c, nFrames)

    def forward(self, clip):
        """(B, N, 3, H, W), H and W multiples of 4 -> the centre frame's
        refill features (B, C, H, W)."""
        b, n = clip.shape[:2]
        l1 = self.feature_extraction(lrelu(self.conv_first(clip.flatten(0, 1))))
        l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(l1))))
        l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(l2))))
        nbr = [l1, l2, l3]
        centre = [lv.reshape(b, n, *lv.shape[1:])[:, n // 2 : n // 2 + 1].expand(b, n, *lv.shape[1:]).flatten(0, 1)
                  for lv in nbr]
        aligned = self.pcd_align(nbr, centre)
        return self.fusion(aligned.reshape(b, n, *aligned.shape[1:]))


class Upsample(nn.Sequential):
    def __init__(self, c: int = NUM_FEAT):
        super().__init__(conv(c, 4 * c), nn.PixelShuffle(2), nn.LeakyReLU(0.1), conv(c, 4 * c), nn.PixelShuffle(2),
                         nn.LeakyReLU(0.1), conv(c, c), nn.LeakyReLU(0.1), conv(c, 3))


class IconVSR(nn.Module):
    def __init__(self, numBlocks: int = NUM_BLOCK):
        super().__init__()
        self.spynet = SpyNet()
        self.edvr = EDVR()
        self.backward_trunk = ConvResidualBlocks(NUM_FEAT + 3, NUM_FEAT, numBlocks)
        self.forward_trunk = ConvResidualBlocks(2 * NUM_FEAT + 3, NUM_FEAT, numBlocks)
        self.backward_fusion = conv(2 * NUM_FEAT, NUM_FEAT)
        self.forward_fusion = conv(2 * NUM_FEAT, NUM_FEAT)
        self.upsample = Upsample()

    def backwardStep(self, x, feat, refill):
        """One backward step: frame x (1, 3, H, W), the warped state, the
        keyframe's refill or None."""
        if refill is not None:
            feat = self.backward_fusion(torch.cat([feat, refill], 1))
        return self.backward_trunk(torch.cat([x, feat], 1))

    def forwardStep(self, x, backward, feat, refill):
        if refill is not None:
            feat = self.forward_fusion(torch.cat([feat, refill], 1))
        return self.forward_trunk(torch.cat([x, backward, feat], 1))

    def output(self, x, feat):
        """The x4 frame (1, 3, 4H, 4W) of frame x and its forward features."""
        return self.upsample(feat) + F.interpolate(x, scale_factor=float(SCALE), mode="bilinear", align_corners=False)


def isKeyframe(t: int, n: int) -> bool:
    """MoePhoto's keyframes in a stream of ``n`` frames: every KEY_STRIDE-th
    frame, and the last frame of each batch of EDVR windows the stream's
    keyframe stage takes.  While frames arrive, a batch is a backward
    chunk's windows; at the end of the stream, first the windows left that
    need no end padding (up to frame n - 1 - REF_TIME // 2), then the padded
    tail."""
    full = n - REF_TIME // 2  # frames whose window the stream fills without end padding
    return t % KEY_STRIDE == 0 or t in {b - 1 for _, b in chunks(full)} or t == n - 1


def edvrWindow(t: int, n: int) -> List[int]:
    """The frames of keyframe t's EDVR clip, t at its centre: the stream's
    start padding puts frames 6, 5, 4 before frame 0, its end padding
    frames n - 5, n - 6, n - 7 after frame n - 1."""
    half = REF_TIME // 2
    out = []
    for s in range(t - half, t + half + 1):
        out.append(half - s if s < 0 else (2 * n - half - 2 - s if s >= n else s))
    return out


def chunks(n: int):
    """The backward chunks [a, b) of a stream of ``n`` frames."""
    return [(a, min(a + BACKWARD_CHUNK, n)) for a in range(0, n, BACKWARD_CHUNK)]


def alignPad(x):
    """(N, 3, h, w) reflection-padded at the bottom and right to multiples of ALIGN."""
    h, w = x.shape[2:]
    ph, pw = -h % ALIGN, -w % ALIGN
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


@torch.no_grad()
def vsrClip(model: IconVSR, frames: List[bytes], h: int, w: int, device,
            keep: Optional[Iterable[int]] = None) -> Dict[int, np.ndarray]:
    """MoePhoto's VSR stream over a whole clip of 16-bit BGR frames ->
    {frame index: (4h, 4w, 3) BGR uint16} for the frames in ``keep`` (all
    by default).  Backward chunks of BACKWARD_CHUNK frames from a zero
    state, each followed by the forward pass over its frames, whose state
    crosses chunks."""
    with fp32Exact():
        return _vsrClip(model, frames, h, w, device, set(range(len(frames))) if keep is None else set(keep))


def _vsrClip(model, frames, h, w, device, keep):
    n = len(frames)
    if not keep:
        return {}
    x = alignPad(torch.cat([frameFromBytes(f, h, w, device) for f in frames]))
    frame = lambda t: x[t : t + 1]
    needed = [(a, b) for a, b in chunks(n) if a <= max(keep)]  # no frame after the last kept one matters
    refill = {t: model.edvr(x[edvrWindow(t, n)][None]) for t in range(needed[-1][1]) if isKeyframe(t, n)}
    out, feat = {}, None
    for a, b in needed:
        back = [None] * (b - a)
        state = None
        for t in reversed(range(a, b)):
            state = (x.new_zeros((1, NUM_FEAT) + x.shape[2:]) if state is None else
                     backWarp(state, model.spynet(frame(t), frame(t + 1)), "zeros"))
            state = model.backwardStep(frame(t), state, refill.get(t))
            back[t - a] = state
        for t in range(a, b):
            feat = (torch.zeros_like(back[0]) if feat is None else
                    backWarp(feat, model.spynet(frame(t), frame(t - 1)), "zeros"))
            feat = model.forwardStep(frame(t), back[t - a], feat, refill.get(t))
            if t in keep:
                out[t] = toBytes16(model.output(frame(t), feat)[:, :, : SCALE * h, : SCALE * w])
    return out


def checkpoint(sd: dict) -> dict:
    """One state dict -> the nested ``{module: state dict}`` file that the
    program's ``iconvsr.getOpt`` loads."""
    return {mod: {k[len(mod) + 1 :]: v for k, v in sd.items() if k.startswith(mod + ".")} for mod in MODULES}
