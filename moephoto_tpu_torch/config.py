"""Layered runtime configuration: a defaults table overlaid by a
versioned ``.user/config.json``, exposed as a live ``Config`` object.

Device policy: ``device`` defaults to ``"cuda"``.  When CUDA is not
available every entry point raises (:meth:`Config.torchDevice`); it never
quietly runs on the CPU.  Callers that want the CPU (tests) set
``config.device = "cpu"`` explicitly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

VERSION = "5.15"

# key -> (default value, optional doc)
defaultConfig: Dict[str, tuple] = {
    "crop_sr": ("auto",),
    "crop_dn": ("auto",),
    "crop_dns": ("auto",),
    "bf16": (True, "compute in bfloat16 with fp32 accumulation on the GPU"),
    "device": ("cuda", "torch device of the compute path; 'cpu' only on request"),
    "ensembleSR": (0,),
    "videoName": ("out_{timestamp}.mkv",),
    "defaultDecodec": ("",),
    "defaultEncodec": ("libx264 -pix_fmt yuv420p",),
    "outDir": ("download",),
    "uploadDir": ("upload",),
    "logPath": (".user/log.txt",),
    "opsPath": (".user/ops.json",),
    "videoPreview": ("jpeg",),
    "maxResultsKept": (1 << 10, "session notes and results the server keeps"),
    "sharedMemSize": (100 * 2**20, "server<->worker image exchange buffer bytes"),
    "port": (2333,),
    "progressDetail": (False,),
    "ffmpegPath": ("ffmpeg", "external ffmpeg binary for video decode/encode"),
    "tileSize": (0, "0 = per-model default tile size"),
    "tileBatch": (0, "0 = per-model default tiles per model call"),
    "meshShape": (
        [],
        "e.g. [2, 4] for a dp x sp mesh over the first 8 cards; [] = single device "
        "(with device 'cpu': that many CPU entries, as the sharding tests use)",
    ),
    "modelDir": ("./model", "root directory of torch checkpoints"),
    "referenceRoot": (
        "",
        "optional read-only reference checkout used as a checkpoint "
        "fallback during development; also settable via the "
        "MOEPHOTO_REFERENCE_ROOT environment variable",
    ),
}

configPath = ".user/config.json"
manifestPath = "manifest.json"


def referenceRoot() -> str:
    """The explicit dev-only reference mount ('' = disabled)."""
    return os.environ.get("MOEPHOTO_REFERENCE_ROOT") or getattr(
        config, "referenceRoot", ""
    )


def compareVersion(a: str, b: str) -> int:
    """Lexicographic dotted-version compare."""
    pa = [int(x) for x in str(a).split(".")]
    pb = [int(x) for x in str(b).split(".")]
    for n0, n1 in zip(pa, pb):
        if n0 != n1:
            return -1 if n0 < n1 else 1
    return (len(pa) > len(pb)) - (len(pa) < len(pb))


def setConfig(target: Dict[str, Any], version: str = VERSION, dir: str = ".") -> None:
    """Fill ``target`` with defaults then overlay the versioned user config."""
    for key, val in defaultConfig.items():
        target[key] = val[0]
    target["version"] = version
    mpath = os.path.join(dir, manifestPath)
    if os.path.exists(mpath):
        with open(mpath, "r", encoding="utf-8") as fp:
            target["version"] = json.load(fp)["version"]
    upath = os.path.join(dir, configPath)
    if os.path.exists(upath):
        with open(upath, "r", encoding="utf-8") as fp:
            try:
                user = json.load(fp)
            except ValueError:
                raise UserWarning("Loading user config failed, fallback to defaults.")
        if compareVersion(version, user.pop("version", version)) > 0:
            raise UserWarning("User config is too old and not supported.")
        for key, value in user.items():
            target[key] = value[0] if isinstance(value, (list, tuple)) else value


class Config:
    """Live config object used by the engine side."""

    def __init__(self, dir: str = "."):
        self.dir = dir
        self.initialize()

    def initialize(self) -> None:
        try:
            setConfig(self.__dict__, VERSION, dir=self.dir)
        except UserWarning as e:  # pragma: no cover - warning path
            import logging

            logging.getLogger("Moe").warning(e)

    # --- device / precision ----------------------------------------------
    def torchDevice(self) -> torch.device:
        """The compute device; raises when CUDA is asked for but absent."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "moephoto_tpu_torch needs a CUDA device (config.device = "
                f"{self.device!r}) and none is available; set "
                "config.device = 'cpu' to run on the CPU on purpose"
            )
        return dev

    def dtype(self) -> torch.dtype:
        """bf16 on the card when ``bf16`` is set, fp32 on the CPU."""
        onCard = torch.device(self.device).type != "cpu"
        return torch.bfloat16 if (self.bf16 and onCard) else torch.float32

    def getConfig(self):
        f = lambda v: 0 if v == "auto" else v
        return tuple(f(self.__dict__[k]) for k in ("crop_sr", "crop_dn", "crop_dns"))

    def getPath(self, **kwargs) -> str:
        """Default video output name from ``videoName``."""
        import time

        kwargs["timestamp"] = int(time.time())
        d = {k: v for k, v in kwargs.items() if k in self.videoName}
        return self.videoName.format(**d)

    def system(self):
        """Free device memory in MiB, one entry a device: each CUDA card's
        from ``torch.cuda.mem_get_info``; with ``device`` 'cpu' the one
        host device, which has no memory stats, as 0.  Raises when CUDA is
        asked for but absent."""
        if self.torchDevice().type == "cpu":
            return [0]
        return [torch.cuda.mem_get_info(i)[0] // 2**20 for i in range(torch.cuda.device_count())]


config = Config()
