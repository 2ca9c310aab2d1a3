"""Image I/O and dtype conversion: images on the host (numpy HWC), raw
video frames between the ffmpeg pipes and the compute device, and the
output's quantisation on the device with its copy to the host."""

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


def quantise(image: torch.Tensor, bitDepth: int = 8) -> torch.Tensor:
    """Float HWC tensor in [0, 1] -> integer tensor on the same device,
    value for value ``toOutput``'s for finite values (the product by
    2^bits is exact in fp32, and the cast truncates as ``astype`` does).

    The dtype sets the bytes that later cross the bus: uint8 to 8 bits,
    int16 to 16, where 16-bit values are carried as int16 bit patterns,
    since torch's uint16 is thinly supported (``fromBuffer`` reads them
    so; ``fromQuantised`` widens them on the host); int32 above.  The
    input is not modified."""
    quant = 1 << bitDepth
    y = image.float() * quant
    y.clamp_(0, quant - 1)
    if bitDepth <= 8:
        return y.to(torch.uint8)
    q = y.to(torch.int32)
    return q.to(torch.int16) if bitDepth <= 16 else q


def toHost(q: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its own.  A device tensor is copied
    into page-locked memory from torch's caching host allocator: the
    array keeps the block alive, and the allocator takes it back once the
    array is dropped, so no later copy overwrites a returned array."""
    if q.device.type == "cpu":
        return q.numpy()
    host = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
    host.copy_(q)
    return host.numpy()


def fromQuantised(arr: np.ndarray, bitDepth: int) -> np.ndarray:
    """``quantise``'s values on the host in ``toOutput``'s dtype: 16-bit
    values widen from their int16 bit patterns to int32."""
    return arr.view(np.uint16).astype(np.int32) if bitDepth == 16 else arr


def fromInt16(x: torch.Tensor) -> torch.Tensor:
    """16-bit values carried as int16 bit patterns -> float32 in [0, 1) on
    their device: the low 16 bits taken back as an integer, then
    u16 / 65536, which is exact."""
    return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / 65536.0


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
        return fromInt16(raw.to(device)).reshape(height, width, 3)
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
