"""Seeded random weights in torch layout.

The real checkpoints are not part of the repository, so parity runs and
the GPU smoke test use random weights made from a seed.  The lite and
ESTRNN draws follow the JAX package's random parameters
(``__graft_entry__._lite2Params``, ESTRNN's ``synthParams``) in the same
order, so the same seed gives the same weights in both packages.  The
sun, AOD, AiLUT, IFRNet, IconVSR, MyNet, NetDN, SEDN, NAFNet, MPRNet,
RRDBNet, ImageCleaning and moire draws are this module's own; the tests
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


def synthESTRNNParams(seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """A random ESTRNN checkpoint as the reference stores it: ``{"cell",
    "fusion", "recons"}``, each a state dict in torch layout (the
    reconstructor's two ConvTranspose2d weights (in, out, k, k)).  The draws
    are those of the JAX package's ESTRNN ``synthParams`` in the same order
    (weights at half the 1/sqrt(fan-in) scale, biases at 0.01), so the same
    seed gives the same weights in both packages."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def t(name, *shape):
        fan = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        sd[name + ".weight"] = (rng.randn(*shape) / np.sqrt(fan) * 0.5).astype(np.float32)
        sd[name + ".bias"] = rng.randn(shape[0]).astype(np.float32) * 0.01

    def rdb(prefix, g, c0):
        for i in range(3):
            t(f"{prefix}.{i}.conv", g, c0 + i * g, 3, 3)
        return c0 + 3 * g

    def tT(name, cin, cout, k):
        sd[name + ".weight"] = (rng.randn(cin, cout, k, k) / np.sqrt(k * k * cin) * 0.5).astype(np.float32)
        sd[name + ".bias"] = rng.randn(cout).astype(np.float32) * 0.01

    t("cell.F_B0", 16, 3, 5, 5)
    t("cell.F_B1.0.3", 16, rdb("cell.F_B1.0", 16, 16), 1, 1)
    t("cell.F_B1.1", 32, 16, 5, 5)
    t("cell.F_B2.0.3", 32, rdb("cell.F_B2.0", 24, 32), 1, 1)
    t("cell.F_B2.1", 64, 32, 5, 5)
    for b in range(15):
        t(f"cell.F_R.RDBs.{b}.3", 80, rdb(f"cell.F_R.RDBs.{b}", 32, 80), 1, 1)
    t("cell.F_R.conv1x1", 80, 15 * 80, 1, 1)
    t("cell.F_R.conv3x3", 80, 80, 3, 3)
    t("cell.F_h.0", 16, 80, 3, 3)
    t("cell.F_h.1.3", 16, rdb("cell.F_h.1", 16, 16), 1, 1)
    t("cell.F_h.2", 16, 16, 3, 3)
    t("fusion.F_f.0", 320, 160)
    t("fusion.F_f.2", 160, 320)
    t("fusion.F_p.0", 320, 160, 1, 1)
    t("fusion.F_p.1", 160, 320, 1, 1)
    t("fusion.condense", 80, 160, 1, 1)
    t("fusion.fusion", 400, 400, 1, 1)
    tT("recons.0", 400, 32, 3)
    tT("recons.1", 32, 16, 3)
    t("recons.2", 3, 16, 5, 5)
    out: Dict[str, Dict[str, np.ndarray]] = {"cell": {}, "fusion": {}, "recons": {}}
    for k, v in sd.items():
        mod, key = k.split(".", 1)
        out[mod][key] = v
    return {mod: _torchDict(p) for mod, p in out.items()}


def _synthByKind(model: torch.nn.Module, seed: int, gain: float) -> Dict[str, torch.Tensor]:
    """Seeded draws for every entry of ``model.state_dict()``, in its order,
    by the kind of module that holds it, each kind around the value a trained
    model keeps (so a dropped or misplaced entry shows in a comparison):
    conv weights at ``gain`` / sqrt(fan-in) and biases at 0.05, PReLU slopes
    around 0.25, LayerNorm weights around 1 and biases around 0, learned
    scalars around 1, NAFNet's ``beta``/``gamma`` uniform in [0.1, 1] (the
    reference starts them at 0, which makes every block the identity)."""
    from moephoto_tpu_torch.models.api import LayerNorm2d

    rng = np.random.RandomState(seed)
    owners = dict(model.named_modules())
    p: Dict[str, np.ndarray] = {}
    for k, v in model.state_dict().items():
        name, _, leaf = k.rpartition(".")
        owner = owners[name]
        if isinstance(owner, torch.nn.PReLU):
            p[k] = 0.25 + 0.05 * rng.randn(*v.shape)
        elif isinstance(owner, LayerNorm2d):
            p[k] = (1.0 if leaf == "weight" else 0.0) + 0.1 * rng.randn(*v.shape)
        elif leaf in ("beta", "gamma"):
            p[k] = rng.uniform(0.1, 1.0, v.shape)
        elif leaf == "scale":
            p[k] = 1.0 + 0.1 * rng.randn(*v.shape)
        elif v.ndim == 4:
            p[k] = rng.randn(*v.shape) * gain / np.sqrt(v[0].numel())
        else:
            p[k] = 0.05 * rng.randn(*v.shape)
    return _torchDict({k: v.astype(np.float32) for k, v in p.items()})


def synthNAFNetParams(width: int = 32, middleBlkNum: int = 12, encBlkNums=(2, 2, 4, 8), decBlkNums=(2, 2, 2, 2),
                      seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random NAFNet (``models/nafnet.NAFNet``; the default
    is NAFNet-SIDD-width32, the ``NAFNet_32`` entry).  Damped draws: every
    block adds its two branches through ``beta`` and ``gamma``."""
    from moephoto_tpu_torch.models.nafnet import NAFNet

    return _synthByKind(NAFNet(width, middleBlkNum, encBlkNums, decBlkNums), seed, gain)


def synthMPRNetParams(nFeat: int = 80, scaleUnetFeats: int = 48, scaleOrsnetFeats: int = 32, numCab: int = 8,
                      seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random MPRNet (``models/mprnet.MPRNet``; the default
    is the denoising configuration).  Damped draws, as the CAB chains add
    one residual after another."""
    from moephoto_tpu_torch.models.mprnet import MPRNet

    return _synthByKind(MPRNet(nFeat, scaleUnetFeats, scaleOrsnetFeats, numCab), seed, gain)


def synthRRDBParams(scale: int = 4, numBlock: int = 23, seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random RRDBNet (``models/restore.RRDBNet``: ``gan4``
    by default, ``gan2`` at scale 2, ``gana4`` with 6 blocks), damped."""
    from moephoto_tpu_torch.models.restore import RRDBNet

    return _synthByKind(RRDBNet(scale, numBlock), seed, gain)


def synthImageCleaningParams(seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random ImageCleaning (``models/restore.ImageCleaning``,
    the ``VSR_Cleaning`` entry), damped over its 20 residual blocks."""
    from moephoto_tpu_torch.models.restore import ImageCleaning

    return _synthByKind(ImageCleaning(), seed, gain)


def synthMoireObjParams(c: int = 64, seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random moire_obj at feature width ``c``
    (``models/demoire.MoireObj``), damped."""
    from moephoto_tpu_torch.models.demoire import MoireObj

    return _synthByKind(MoireObj(c), seed, gain)


def synthMoireScreenGanParams(c: int = 64, seed: int = 0, gain: float = 0.7) -> Dict[str, torch.Tensor]:
    """State dict of a random moire_screen_gan at feature width ``c``
    (``models/demoire.MoireScreenGan``), damped."""
    from moephoto_tpu_torch.models.demoire import MoireScreenGan

    return _synthByKind(MoireScreenGan(c), seed, gain)
