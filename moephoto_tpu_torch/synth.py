"""Seeded random weights in torch layout.

The real checkpoints are not part of the repository, so parity runs and
the GPU smoke test use random weights made from a seed.  The lite draws
follow the JAX package's random lite parameters
(``__graft_entry__._lite2Params``) in the same order, so the same seed
gives the same weights in both packages.  The sun, AOD, AiLUT, IFRNet,
IconVSR, MyNet, NetDN and SEDN draws are this module's own; the tests
hand one dict to both packages.

Conv weights are drawn at 1/sqrt(fan-in), where a ConvTranspose's fan-in
is the taps one output pixel sees (cin * k * k / stride**2); biases,
PReLU slopes and norm parameters get small seeded noise around their
defaults, so a dropped or misplaced parameter shows in a comparison.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def synthLite2Params(upscale: int = 2, seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random MoeNet_lite2 ×``upscale`` (OIHW, fp32)."""
    rng = np.random.RandomState(seed)
    nUps = int(upscale).bit_length() - 1
    p: Dict[str, np.ndarray] = {}

    def conv(name, kh, kw, cin, cout, bias=False):
        w = rng.randn(kh, kw, cin, cout).astype(np.float32) * (1.0 / np.sqrt(kh * kw * cin))
        w = w.astype(np.float32)  # the float64 scale promotes; round as jnp.asarray does
        p[name + ".weight"] = np.transpose(w, (3, 2, 0, 1))  # HWIO draw -> OIHW
        if bias:
            p[name + ".bias"] = np.zeros((cout,), np.float32)

    conv("conv_input", 1, 1, 1, 48)
    conv("conv_input2", 1, 1, 48, 48)
    p["relu.weight"] = np.full((1,), 0.25, np.float32)
    for blk in ("convt_F11", "convt_F12", "convt_F13"):
        conv(blk + ".conv_1", 3, 3, 48, 48)
        conv(blk + ".conv_2", 3, 3, 48, 48)
        p[blk + ".relu.weight"] = np.full((1,), 0.25, np.float32)
        conv(blk + ".se.conv_du.0", 1, 1, 48, 3, bias=True)
        conv(blk + ".se.conv_du.2", 1, 1, 3, 48, bias=True)
    for path in ("ures", "uim"):
        for i in range(nUps):
            conv(f"{path}.{i}.0", 1, 1, 48, 192, bias=True)
            p[f"{path}.{i}.2.weight"] = np.full((1,), 0.25, np.float32)
    conv("convt_R1", 1, 1, 48, 1)
    conv("convt_I1", 1, 1, 48, 1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}


def _drawer(rng: np.random.RandomState, p: Dict[str, np.ndarray]):
    def conv(name, cin, cout, k, bias=True, transpose=False, stride=1):
        fanIn = cin * k * k // (stride * stride if transpose else 1)
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        p[name + ".weight"] = (rng.randn(*shape) / np.sqrt(fanIn)).astype(np.float32)
        if bias:
            p[name + ".bias"] = (0.1 * rng.randn(cout)).astype(np.float32)

    def prelu(name):
        p[name + ".weight"] = (0.25 + 0.05 * rng.randn(1)).astype(np.float32)

    def norm(name, c, running=False):
        p[name + ".weight"] = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
        p[name + ".bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        if running:
            p[name + ".running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
            p[name + ".running_var"] = (1.0 + 0.2 * rng.rand(c)).astype(np.float32)
            p[name + ".num_batches_tracked"] = np.zeros((), np.int64)

    return conv, prelu, norm


def _torchDict(p: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}


def synthSunParams(seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random sun_demoire (``models/demoire.SunDemoire``)."""
    from moephoto_tpu_torch.models.demoire import SUN_DOWNS

    rng = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    conv, prelu, _ = _drawer(rng, p)
    for i, (cin, cm, cout) in enumerate(SUN_DOWNS):
        conv(f"downs.{i}.down", cin, cm, 3)
        prelu(f"downs.{i}.relu")
        conv(f"downs.{i}.convt_R1", cm, cout, 3)
        if i == 0:
            conv("branches.0.0", cout, 3, 3)
            prelu("branches.0.1")
            continue
        for j in range(i):
            conv(f"branches.{i}.{2 * j}", cout, cout, 4, transpose=True, stride=2)
            prelu(f"branches.{i}.{2 * j + 1}")
        conv(f"branches.{i}.{2 * i}", cout, 3, 3)
    return _torchDict(p)


def synthAODParams(seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random AOD-Net (``models/restore.AODNet``):
    3-channel convs of kernel 1/3/5/7/3 on 3/3/6/6/12 input channels."""
    rng = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    conv, _, _ = _drawer(rng, p)
    for i, (cin, k) in enumerate(((3, 1), (3, 3), (6, 5), (6, 7), (12, 3))):
        conv(f"conv{i + 1}", cin, 3, k)
    return _torchDict(p)


def identityLut(D: int) -> np.ndarray:
    """(3, D, D, D) red-minor LUT that maps a uniform grid to itself."""
    g = np.linspace(0.0, 1.0, D, dtype=np.float32)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([r, gg, b]).astype(np.float32)


def synthAiLUTParams(backbone: str = "tpami", nRanks: int = 3, seed: int = 0,
                     nVertices: int = 33) -> Dict[str, torch.Tensor]:
    """State dict of a random AiLUT (``models/ailut.AiLUT``).

    Widths are the published ones (AdaInt, CVPR 2022): the TPAMI backbone
    16/32/64/128/128 with 512 codes, ResNet-18 with 512.  The first LUT
    basis is the identity plus noise and the rank weights lean on it, so
    the LUT stays near the identity without being it; the interval logits
    carry seeded noise, so the vertices are not uniform."""
    from moephoto_tpu_torch.models.ailut import TPAMI_WIDTHS

    rng = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    conv, _, norm = _drawer(rng, p)
    if backbone == "tpami":
        cin = 3
        for i, cout in enumerate(TPAMI_WIDTHS):
            conv(f"backbone.{i}.0", cin, cout, 3)
            if i < 4:
                norm(f"backbone.{i}.2", cout)
            cin = cout
        nFeats = TPAMI_WIDTHS[-1] * 4
    elif backbone == "res18":
        conv("backbone.conv1", 3, 64, 7, bias=False)
        norm("backbone.bn1", 64, running=True)
        cin = 64
        for li, (cout, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            for bi in range(2):
                pre = f"backbone.layer{li + 1}.{bi}"
                conv(pre + ".conv1", cin, cout, 3, bias=False)
                norm(pre + ".bn1", cout, running=True)
                conv(pre + ".conv2", cout, cout, 3, bias=False)
                norm(pre + ".bn2", cout, running=True)
                if bi == 0 and (stride != 1 or cin != cout):
                    conv(pre + ".downsample.0", cin, cout, 1, bias=False)
                    norm(pre + ".downsample.1", cout, running=True)
                cin = cout
        nFeats = 512
    else:
        raise ValueError(f"AiLUT backbone {backbone!r} not in ('tpami', 'res18')")
    D = nVertices
    lin = lambda nOut, nIn, scale: (scale * rng.randn(nOut, nIn) / np.sqrt(nIn)).astype(np.float32)
    p["lut_generator.weights_generator.weight"] = lin(nRanks, nFeats, 0.05)
    p["lut_generator.weights_generator.bias"] = np.eye(1, nRanks, dtype=np.float32)[0]
    basis = 0.05 * rng.randn(3 * D**3, nRanks)
    basis[:, 0] += identityLut(D).reshape(-1)
    p["lut_generator.basis_luts_bank.weight"] = basis.astype(np.float32)
    p["adaint.intervals_generator.weight"] = lin(3 * (D - 1), nFeats, 0.05)
    p["adaint.intervals_generator.bias"] = (0.3 * rng.randn(3 * (D - 1))).astype(np.float32)
    return _torchDict(p)


def synthIFRNetParams(size: str = "M", seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """A random IFRNet-S/M/L checkpoint as the reference stores it:
    ``{"encoder": sd, "decoder": sd}`` (``models/ifrnet.IFRNet``, keys
    without the module prefix), widths from ``Channels``/``SideChannels``
    and ``decoderChannels``; per-channel PReLU slopes."""
    from moephoto_tpu_torch.models.ifrnet import SideChannels, decoderChannels, widths

    rng = np.random.RandomState(seed)
    enc: Dict[str, np.ndarray] = {}
    dec: Dict[str, np.ndarray] = {}
    convE, _, _ = _drawer(rng, enc)
    convD, _, _ = _drawer(rng, dec)

    def prelu(p, name, c):
        p[name + ".weight"] = (0.25 + 0.05 * rng.randn(c)).astype(np.float32)

    cin = 3
    for l, (c, k) in enumerate(widths(size)):
        convE(f"pyramids.{l}.0.0", cin, c, k)
        prelu(enc, f"pyramids.{l}.0.1", c)
        convE(f"pyramids.{l}.1.0", c, c, 3)
        prelu(enc, f"pyramids.{l}.1.1", c)
        cin = c
    side = SideChannels[size]
    for d, (cin, mid, cout) in enumerate(decoderChannels(size)):
        pre = f"decoders.{d}"
        convD(pre + ".0.0", cin, mid, 3)
        prelu(dec, pre + ".0.1", mid)
        for name, c in (("conv1", mid), ("conv2", side), ("conv3", mid), ("conv4", side)):
            convD(f"{pre}.1.{name}.0", c, c, 3)
            prelu(dec, f"{pre}.1.{name}.1", c)
        convD(pre + ".1.conv5", mid, mid, 3)
        prelu(dec, pre + ".1.prelu", mid)
        convD(pre + ".2", mid, cout, 4, transpose=True, stride=2)
    return {"encoder": _torchDict(enc), "decoder": _torchDict(dec)}


def _synthFromModule(model: torch.nn.Module, seed: int, gain: float) -> Dict[str, torch.Tensor]:
    """Seeded draws for every entry of ``model.state_dict()``: conv weights
    at ``gain`` / sqrt(fan-in), biases at 0.01, PReLU slopes around 0.25,
    ARSB scales around 1 (the reference's init)."""
    rng = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    for k, v in model.state_dict().items():
        if v.ndim == 4:
            p[k] = (rng.randn(*v.shape) * gain / np.sqrt(v[0].numel())).astype(np.float32)
        elif k.endswith(".scale"):
            p[k] = (1.0 + 0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("relu.weight") or k.endswith(".2.weight"):
            p[k] = (0.25 + 0.05 * rng.randn(*v.shape)).astype(np.float32)
        else:
            p[k] = (0.01 * rng.randn(*v.shape)).astype(np.float32)
    return _torchDict(p)


def synthMyNetParams(scale: int = 2, seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random MyNet x``scale`` (``models/sr.MyNetSR``).
    Damped draws (0.7 / sqrt(fan-in)): each of the six ARSBs adds its
    branch to its input at a scale near 1, and the sum stays of order 1."""
    from moephoto_tpu_torch.models.sr import MyNetSR

    return _synthFromModule(MyNetSR(scale), seed, 0.7)


def synthNetDNParams(seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random NetDN (``models/sr.NetDN``), damped as
    :func:`synthMyNetParams`."""
    from moephoto_tpu_torch.models.sr import NetDN

    return _synthFromModule(NetDN(), seed, 0.7)


def synthSEDNParams(seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of a random SEDN (``models/sr.SEDN``).  Damped draws
    (0.7 / sqrt(fan-in)), so the sixteen residual blocks' sum stays of
    order 1 and finite in bf16."""
    from moephoto_tpu_torch.models.sr import SEDN

    return _synthFromModule(SEDN(), seed, 0.7)


# conv_offset's gain over the damped draw: it sets the DCN offsets' spread
# (see synthIconVSRParams)
ICONVSR_OFFSET_GAIN = 240.0


def synthIconVSRParams(seed: int = 0, numBlocks: int = 30) -> Dict[str, Dict[str, torch.Tensor]]:
    """A random IconVSR checkpoint as the reference stores it:
    ``{module: state_dict}`` for spynet, edvr, both trunks (``numBlocks``
    residual blocks each), both fusions and the upsampler, keys and shapes
    those of ``models/iconvsr.IconVSR`` (the JAX package's ``edvrApply``,
    ``_pcdAlign`` and ``_tsaFusion`` calls; its ``synthParams`` leaves
    EDVR out).

    Damped draws, as the JAX bench damps its random modules so that the PCD
    cascade stays finite: every conv weight at half the 1/sqrt(fan-in)
    scale, biases at 0.01.  The DCNs' ``conv_offset`` weights are
    ``ICONVSR_OFFSET_GAIN`` times larger, so the offsets spread over a few
    pixels: most under 1 px, some beyond 3 px (past the JAX package's
    widest window tier)."""
    from moephoto_tpu_torch.models.iconvsr import IconVSR

    rng = np.random.RandomState(seed)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, module in IconVSR(numBlocks).named_children():
        p: Dict[str, np.ndarray] = {}
        for k, v in module.state_dict().items():
            if v.ndim == 4:
                gain = 0.5 * (ICONVSR_OFFSET_GAIN if "conv_offset" in k else 1.0)
                p[k] = (rng.randn(*v.shape) * gain / np.sqrt(v[0].numel())).astype(np.float32)
            else:
                p[k] = (0.01 * rng.randn(*v.shape)).astype(np.float32)
        out[name] = _torchDict(p)
    return out
