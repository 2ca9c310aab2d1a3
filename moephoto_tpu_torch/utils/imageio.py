"""Image I/O and dtype conversion: images on the host (numpy HWC), raw
video frames between the ffmpeg pipes and the compute device."""

from __future__ import annotations

import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image


def npDtypeFor(bitDepth: int):
    if bitDepth <= 8:
        return np.uint8
    if bitDepth <= 16:
        return np.uint16
    return np.int32


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


def toBuffer(image: Optional[np.ndarray], bitDepth: int = 16) -> Optional[bytes]:
    """Integer HWC image -> raw bytes for the encode pipe."""
    if image is None:
        return None
    return np.ascontiguousarray(image.astype(npDtypeFor(bitDepth))).tobytes()


def fromBuffer(buffer, height: int, width: int, bitDepth: int = 16,
               device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    """Raw 3-channel frame bytes -> float32 HWC in [0, 1) on ``device``.

    A 16-bit frame goes to the device as it is (6 bytes a pixel) and is
    converted there: the bytes are read as int16, since torch's uint16 is
    thinly supported, and the low 16 bits taken back as an integer, so
    each value is u16 / 65536 exactly, as the JAX package's native codec
    gives it."""
    if not buffer:
        return None
    n = height * width * 3
    if bitDepth == 16:
        with warnings.catch_warnings():
            # bytes are read-only; the tensor is only read, to upload it
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(buffer, dtype=torch.int16, count=n)
        u16 = raw.to(device).to(torch.int32) & 0xFFFF
        return (u16.to(torch.float32) / 65536.0).reshape(height, width, 3)
    arr = np.frombuffer(buffer, dtype=npDtypeFor(bitDepth), count=n)
    x = torch.from_numpy(arr.astype(np.float32) / (1 << bitDepth))
    return x.reshape(height, width, 3).to(device)


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
