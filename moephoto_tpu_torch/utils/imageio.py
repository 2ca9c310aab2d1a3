"""Image I/O and dtype conversion on the host (numpy HWC)."""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
from PIL import Image


def toFloat(image: np.ndarray, bitDepth: int = 8) -> np.ndarray:
    """Integer HWC image -> float32 HWC in [0, 1) (quant = 1 << bits)."""
    return np.asarray(image, dtype=np.float32) / (1 << bitDepth)


def toOutput(image, bitDepth: int = 8) -> np.ndarray:
    """Float HWC in [0, 1] -> integer HWC."""
    quant = 1 << bitDepth
    if bitDepth <= 8:
        dtype = np.uint8
    elif bitDepth <= 15:
        dtype = np.int16
    else:
        dtype = np.int32
    arr = np.asarray(image, dtype=np.float32) * quant
    np.clip(arr, 0, quant - 1, out=arr)
    return arr.astype(dtype)


def dedupeAlpha(x: np.ndarray) -> Tuple[str, np.ndarray]:
    """Drop an all-opaque alpha channel."""
    if float(np.sum(255 - x[:, :, 3].astype(np.float32))) < 1:
        return "RGB", x[:, :, :3]
    return "RGBA", x


def readFile(file, context=None) -> np.ndarray:
    """Read an image file/stream to an HWC uint array: palette images
    become RGB (palette kept on ``context`` for P-mode round trips),
    all-opaque RGBA collapses to RGB, grayscale becomes (H, W, 1)."""
    image = Image.open(file)
    mode = image.mode
    if context is not None:
        context.imageMode = mode
    if mode == "P":
        if context is not None:
            context.palette = image
        image = image.convert("RGB")
    arr = np.array(image)
    if mode == "RGBA":
        newMode, arr = dedupeAlpha(arr)
        if context is not None:
            context.imageMode = newMode
    if arr.ndim == 2:
        return arr.reshape(*arr.shape, 1)
    if arr.shape[2] in (3, 4):
        return arr
    raise RuntimeError("Unknown image format")


def writeFile(image: np.ndarray, name, context=None, *args):
    """Write an HWC integer image."""
    if not name:
        name = genNameByTime()
    elif hasattr(name, "seek"):
        name.seek(0)
    if image.shape[2] == 1:
        image = image[..., 0]
    pil = Image.fromarray(image)
    if context is not None and getattr(context, "imageMode", None) == "P":
        pil = pil.quantize(palette=context.palette)
    pil.save(name, *args)
    return name


outDir = "download"
genNameByTime = lambda: "{}/output_{}.png".format(outDir, int(time.time()))
