"""Model registry: step-JSON model names -> executable models.

Same model keys and checkpoint file layout as the JAX package's
registry; each entry resolves to a :class:`ModelExec` with a static
:class:`TileSpec`.  Ported: of the SR registry MoeNet_lite2
(``lite2/4/8``) and MyNet (``a2/a3/a4``, ``p2/p3/p4``); of the DN registry
SEDN (``15/25/50``) and NetDN (``lite5/10/15``); of the dehaze registry AOD
(``dehaze``), ``sun`` and the three AiLUT entries.  The keys in
``SR_NOT_PORTED``, ``DN_NOT_PORTED`` and ``DEHAZE_NOT_PORTED`` raise
``NotImplementedError`` naming the ROADMAP item they wait for (A7: RRDB,
ImageCleaning, the moire models, NAFNet, MPRNet).  Temporal models
(``models/ifrnet.py``, ``models/iconvsr.py``) load through
:func:`modelPath` in their own ``getOpt``, as in the JAX package.

The Y-channel entries run unpacked (``channelSplit``, no plane packing).
Packing exists in the JAX package to fill the TPU's 128-lane matrix unit
with a 48- or 64-channel trunk; on the GPU its block-diagonal weights only
double the trunk's FLOPs.
"""

from __future__ import annotations

import importlib
import logging
import os
from dataclasses import replace
from typing import Dict, Optional

import torch

from moephoto_tpu_torch.config import config, referenceRoot
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.engine.tiling import TileSpec
from moephoto_tpu_torch.models import api as M

log = logging.getLogger("Moe")

_modelCache: Dict[str, ModelExec] = {}
_paramsCache: Dict[str, object] = {}


def modelPath(rel: str) -> str:
    """Resolve a checkpoint path: ``modelDir`` replaces the leading
    ``model/`` component.  A reference checkout is consulted only when
    explicitly configured (``referenceRoot`` or ``MOEPHOTO_REFERENCE_ROOT``)."""
    if os.path.isabs(rel):
        return rel
    rel = rel.lstrip("./")
    sub = rel[len("model/"):] if rel.startswith("model/") else rel
    candidates = [os.path.join(config.modelDir, sub), rel]
    ref = referenceRoot()
    if ref:
        candidates.append(os.path.join(ref, rel))
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return candidates[0]


PORTED_FAMILIES = ("sr", "restore", "demoire", "ailut")  # modules of moephoto_tpu_torch.models


def _lazyImport(family: str):
    if family not in PORTED_FAMILIES:
        raise KeyError(f"model family {family!r} is not ported yet")
    return importlib.import_module(f"moephoto_tpu_torch.models.{family}")


def _entry(family, fn, path, spec, channelSplit=False, outC=None, prepare=None,
           convT=None, fp32=False, noTile=False):
    # prepare: map on the full image before the model; convT: predicate
    # naming ConvTranspose weights in a JAX-layout .npz; fp32: run in fp32
    # whatever config.bf16 says; noTile: run whole (ModelExec.applyWhole)
    return dict(family=family, fn=fn, path=path, spec=spec, channelSplit=channelSplit,
                outC=outC, prepare=prepare, convT=convT, fp32=fp32, noTile=noTile)


def _normalize05(x):
    """Normalize(mean=.5, std=.5) of the AOD dehaze entry."""
    return (x - 0.5) / 0.5


# --- SR registry ----------------------------------------------------------
_SPEC_LITE = lambda sc: TileSpec(tile=256, pad=5, align=8, scale=sc, batch=10 if sc <= 4 else 2)

_SPEC_Y_SR = lambda sc: TileSpec(tile=256, pad=9 if sc == 3 else 5, align=8, scale=sc, batch=8 if sc <= 2 else 4)

SR_REGISTRY = {
    "a2": _entry("sr", "net2x", "model/a2/model_new.pth", _SPEC_Y_SR(2), channelSplit=True),
    "a3": _entry("sr", "net3x", "model/a3/model_new.pth", _SPEC_Y_SR(3), channelSplit=True),
    "a4": _entry("sr", "net4x", "model/a4/model_new.pth", _SPEC_Y_SR(4), channelSplit=True),
    "p2": _entry("sr", "net2x", "model/p2/model_new.pth", _SPEC_Y_SR(2), channelSplit=True),
    "p3": _entry("sr", "net3x", "model/p3/model_new.pth", _SPEC_Y_SR(3), channelSplit=True),
    "p4": _entry("sr", "net4x", "model/p4/model_new.pth", _SPEC_Y_SR(4), channelSplit=True),
    "lite2": _entry("sr", "moeNetLite2x2", "model/lite/model.pth", _SPEC_LITE(2), channelSplit=True),
    "lite4": _entry("sr", "moeNetLite2x4", "model/lite/model_4.pth", _SPEC_LITE(4), channelSplit=True),
    "lite8": _entry("sr", "moeNetLite2x8", "model/lite/model_8.pth", _SPEC_LITE(8), channelSplit=True),
}
SR_NOT_PORTED = {"gan2", "gan4", "gana4"}  # RRDB: ROADMAP A7

# --- DN registry ----------------------------------------------------------
_SPEC_DN = TileSpec(256, 7, 8, 1.0, 8)
DN_REGISTRY = {
    "15": _entry("sr", "sedn", "model/l15/model_new.pth", _SPEC_DN, channelSplit=True),
    "25": _entry("sr", "sedn", "model/l25/model_new.pth", _SPEC_DN, channelSplit=True),
    "50": _entry("sr", "sedn", "model/l50/model_new.pth", _SPEC_DN, channelSplit=True),
    "lite5": _entry("sr", "netDN", "model/dn_lite5/model_new.pth", _SPEC_DN, channelSplit=True),
    "lite10": _entry("sr", "netDN", "model/dn_lite10/model_new.pth", _SPEC_DN, channelSplit=True),
    "lite15": _entry("sr", "netDN", "model/dn_lite15/model_new.pth", _SPEC_DN, channelSplit=True),
}
DN_NOT_PORTED = {"MPRNet_denoising", "NAFNet_32", "NAFNet_64", "VSR_Cleaning"}  # ROADMAP A7

# --- dehaze / deblur / derain / demoire / retouch -------------------------
_sunConvT = lambda k, s: s[2] == 4
DEHAZE_REGISTRY = {
    "dehaze": _entry("restore", "aodNet", "model/dehaze/AOD_net_epoch_relu_10.pth",
                     TileSpec(256, 8, 8, 1.0, 8), prepare=_normalize05),
    "sun": _entry("demoire", "sunDemoire", "model/demoire/sun_epoch_200.pth",
                  TileSpec(256, 16, 32, 1.0, 4), convT=_sunConvT),
    "AiLUT_sRGB_3": _entry("ailut", "ailutTPAMI", "model/AiLUT/AiLUT-FiveK-sRGB.pth",
                           TileSpec(256, 8, 8, 1.0, 1), fp32=True, noTile=True),
    "AiLUT_XYZ_3": _entry("ailut", "ailutTPAMI", "model/AiLUT/AiLUT-FiveK-XYZ.pth",
                          TileSpec(256, 8, 8, 1.0, 1), fp32=True, noTile=True),
    "AiLUT_sRGB_5": _entry("ailut", "ailutRes18", "model/AiLUT/AiLUT-PPR10KA-sRGB.pth",
                           TileSpec(256, 8, 8, 1.0, 1), fp32=True, noTile=True),
}
DEHAZE_NOT_PORTED = {"moire_obj", "moire_screen_gan", "MPRNet_deblurring", "MPRNet_deraining",
                     "NAFNet_deblur_32", "NAFNet_deblur_64", "NAFNet_deblur_JPEG_64"}  # ROADMAP A7


def _applyConfigSpec(entry: dict, kind: str) -> TileSpec:
    """Apply user tile-size caps (``crop_sr``/``crop_dn``/``crop_dns`` and
    ``tileSize``/``tileBatch``) to the entry's static spec."""
    spec = entry["spec"]
    caps = dict(zip(("sr", "dn", "dns"), config.getConfig()))
    cap = caps.get(kind, 0) or config.tileSize
    if cap:
        tile = max(spec.align, (int(cap) // spec.align) * spec.align)
        if tile > 2 * spec.pad:
            spec = replace(spec, tile=tile)
    if config.tileBatch:
        spec = replace(spec, batch=int(config.tileBatch))
    return spec


def buildExec(entry: dict, strength: float = 1.0, ensemble: int = 0, kind: str = "") -> ModelExec:
    """Instantiate (and cache) a ModelExec from a registry entry; an
    ``fp32`` entry runs in fp32 whatever ``config.bf16`` says."""
    device = config.torchDevice()
    dtype = torch.float32 if entry["fp32"] else config.dtype()
    key = entry["path"]
    fullKey = f"{key}|{strength}|{ensemble}|{device}|{dtype}"
    if fullKey in _modelCache:
        return _modelCache[fullKey]
    pKey = f"{key}|{device}|{dtype}"
    if pKey not in _paramsCache:
        path = modelPath(entry["path"])
        log.info("loading model %s", path)
        model = getattr(_lazyImport(entry["family"]), entry["fn"])()
        model.load_state_dict(M.loadTorchWeights(path, entry["convT"]), strict=True)
        model = model.to(device=device, dtype=dtype).eval()
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        _paramsCache[pKey] = model
    ex = ModelExec(
        _paramsCache[pKey],
        _applyConfigSpec(entry, kind),
        channelSplit=entry["channelSplit"],
        outC=entry["outC"],
        prepare=entry["prepare"],
        strength=strength,
        ensemble=ensemble,
        dtype=dtype,
        name=key,
        device=device,
    )
    ex.noTile = entry["noTile"]
    _modelCache[fullKey] = ex
    return ex


def getSR(opt: dict) -> Optional[ModelExec]:
    """SR step options -> ModelExec."""
    name = opt["model"] + str(int(opt["scale"]))
    if name in SR_NOT_PORTED:
        raise NotImplementedError(f"SR model {name!r} is not ported yet (ROADMAP A7)")
    if name not in SR_REGISTRY:
        return None
    ens = opt.get("ensemble", config.ensembleSR)
    ens = ens if 0 <= int(ens) <= 7 else config.ensembleSR
    return buildExec(SR_REGISTRY[name], ensemble=int(ens), kind="sr")


def getDN(opt: dict) -> ModelExec:
    """DN step options -> ModelExec: ``strength`` blends with the input;
    the ``lite*`` models take the ``crop_dn`` tile cap, the others
    ``crop_dns``."""
    model = opt["model"]
    if model in DN_NOT_PORTED:
        raise NotImplementedError(f"DN model {model!r} is not ported yet (ROADMAP A7)")
    kind = "dn" if model.startswith("lite") else "dns"
    return buildExec(DN_REGISTRY[model], strength=float(opt.get("strength", 1.0)), kind=kind)


def getDehaze(opt: dict) -> ModelExec:
    """dehaze/deblur/derain/demoire/retouch step options -> ModelExec."""
    model = opt.get("model", "dehaze")
    if model in DEHAZE_NOT_PORTED:
        raise NotImplementedError(f"dehaze model {model!r} is not ported yet (ROADMAP A7)")
    return buildExec(DEHAZE_REGISTRY[model], strength=float(opt.get("strength", 1.0)))
