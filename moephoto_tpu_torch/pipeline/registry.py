"""Model registry: step-JSON model names -> executable models.

Same model keys and checkpoint file layout as the JAX package's
registry; each entry resolves to a :class:`ModelExec` with a static
:class:`TileSpec`.  Ported so far: the MoeNet_lite2 SR entries.

The lite entries run unpacked (``channelSplit``, no plane packing).
Packing exists in the JAX package to fill the TPU's 128-lane matrix unit
with a 48-channel trunk; on the GPU its block-diagonal weights only
double the trunk's FLOPs.
"""

from __future__ import annotations

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


def _lazyImport(family: str):
    if family == "sr":
        from moephoto_tpu_torch.models import sr

        return sr
    raise KeyError(f"model family {family!r} is not ported yet")


def _entry(family, fn, path, spec, channelSplit=False, outC=None):
    return dict(family=family, fn=fn, path=path, spec=spec, channelSplit=channelSplit, outC=outC)


# --- SR registry ----------------------------------------------------------
_SPEC_LITE = lambda sc: TileSpec(tile=256, pad=5, align=8, scale=sc, batch=10 if sc <= 4 else 2)

SR_REGISTRY = {
    "lite2": _entry("sr", "moeNetLite2x2", "model/lite/model.pth", _SPEC_LITE(2), channelSplit=True),
    "lite4": _entry("sr", "moeNetLite2x4", "model/lite/model_4.pth", _SPEC_LITE(4), channelSplit=True),
    "lite8": _entry("sr", "moeNetLite2x8", "model/lite/model_8.pth", _SPEC_LITE(8), channelSplit=True),
}


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


def buildExec(entry: dict, ensemble: int = 0, kind: str = "") -> ModelExec:
    """Instantiate (and cache) a ModelExec from a registry entry."""
    device = config.torchDevice()
    dtype = config.dtype()
    key = entry["path"]
    fullKey = f"{key}|{ensemble}|{device}|{dtype}"
    if fullKey in _modelCache:
        return _modelCache[fullKey]
    pKey = f"{key}|{device}|{dtype}"
    if pKey not in _paramsCache:
        path = modelPath(entry["path"])
        log.info("loading model %s", path)
        model = getattr(_lazyImport(entry["family"]), entry["fn"])()
        model.load_state_dict(M.loadTorchWeights(path), strict=True)
        model = model.to(device=device, dtype=dtype).eval()
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        _paramsCache[pKey] = model
    ex = ModelExec(
        _paramsCache[pKey],
        _applyConfigSpec(entry, kind),
        channelSplit=entry["channelSplit"],
        outC=entry["outC"],
        ensemble=ensemble,
        dtype=dtype,
        name=key,
        device=device,
    )
    _modelCache[fullKey] = ex
    return ex


def getSR(opt: dict) -> Optional[ModelExec]:
    """SR step options -> ModelExec."""
    name = opt["model"] + str(int(opt["scale"]))
    if name not in SR_REGISTRY:
        return None
    ens = opt.get("ensemble", config.ensembleSR)
    ens = ens if 0 <= int(ens) <= 7 else config.ensembleSR
    return buildExec(SR_REGISTRY[name], ensemble=int(ens), kind="sr")
