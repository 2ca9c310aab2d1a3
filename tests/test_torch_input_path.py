"""The input path on the device (``pipeline/steps.toDevice``: the image's
integers uploaded and widened there) against the host path it replaced:
``astype(np.float32) / 255.0`` or ``/ 65536.0`` on the host, then the
upload.  Bit for bit, in the dtype, shape and layout the next step gets,
and the bytes that cross counted as ``in_bytes``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline import steps
from moephoto_tpu_torch.utils import imageio
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def onDevice(monkeypatch):
    """Set ``config.device`` to the test's device; skip ``cuda`` without one."""

    def use(name):
        if name == "cuda" and not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        monkeypatch.setattr(config, "device", name)
        return torch.device(name)

    return use


def hostInput(arr):
    """The replaced path: the conversion on the host, as a contiguous array."""
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65536.0
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


def rgbaCollapsed():
    """An all-opaque RGBA image after ``readFile``'s collapse: a strided view."""
    rgba = np.random.RandomState(2).randint(0, 256, (21, 34, 4)).astype(np.uint8)
    rgba[..., 3] = 255
    mode, arr = imageio.dedupeAlpha(rgba)
    assert mode == "RGB" and not arr.flags.c_contiguous
    return arr


IMAGES = {
    "all_bytes": lambda: np.repeat(np.arange(256, dtype=np.uint8), 3).reshape(16, 16, 3),
    "uint8_rgb": lambda: np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8),
    "rgba_collapsed": rgbaCollapsed,
    "gray": lambda: np.random.RandomState(1).randint(0, 256, (19, 23, 1)).astype(np.uint8),
    "all_uint16": lambda: np.arange(65536, dtype=np.uint16).reshape(128, 512, 1),
    "uint16_rgb": lambda: np.random.RandomState(3).randint(0, 65536, (15, 26, 3)).astype(np.uint16),
    "float32": lambda: np.random.RandomState(4).uniform(-0.1, 1.1, (13, 17, 3)).astype(np.float32),
    "int32": lambda: np.random.RandomState(5).randint(0, 65536, (11, 9, 1)).astype(np.int32),
}


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("name", list(IMAGES))
def test_toDevice_matches_the_host_conversion(onDevice, dev, name):
    """Each value bit-equal to the host's conversion, float32 HWC,
    contiguous, on the compute device; the input is unchanged."""
    d = onDevice(dev)
    arr = IMAGES[name]()
    before = arr.copy()
    got = steps.toDevice(arr)
    want = hostInput(arr)
    assert got.device.type == d.type and got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want.shape
    host = got.cpu().numpy()
    assert np.array_equal(host, want) and np.array_equal(host.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(arr, before)


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_toDevice_moves_a_tensor(onDevice, dev, dtype):
    """A tensor (a ``buffer`` frame) is only cast to float32 and moved."""
    d = onDevice(dev)
    x = torch.rand(7, 10, 3, dtype=torch.float64).to(dtype)
    got = steps.toDevice(x)
    assert got.device.type == d.type and got.dtype == torch.float32
    assert torch.equal(got.cpu(), x.to(torch.float32))


def moeEvents(prof):
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("moe.")]
    return sorted(out, key=lambda e: (e[1], -e[2]))


@pytest.mark.parametrize("dtype, size", [(np.uint8, 1), (np.uint16, 2), (np.float32, 4)])
def test_in_bytes_counts_the_upload(monkeypatch, dtype, size):
    """``moe.count.in_bytes=<n>`` once an image inside ``moe.step.toTorch``,
    n = values x bytes a value (1 at 8 bits, 2 at 16, 4 for float32)."""
    monkeypatch.setattr(config, "device", "cpu")
    fs, ns, _ = steps.procInput("file", 8, [], dict(bitDepth=8, channel=0, source=0))
    assert len(fs) == len(ns) == 1
    image = np.ones((6, 5, 3), dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fs[0](image)
    evs = moeEvents(prof)
    assert [e[0] for e in evs] == ["moe.step.toTorch", f"moe.count.in_bytes={image.size * size}"]
    assert evs[0][1] <= evs[1][1] and evs[1][2] <= evs[0][2]


def test_in_bytes_skips_a_tensor(monkeypatch):
    """A tensor is already the device's input: nothing counted."""
    monkeypatch.setattr(config, "device", "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.toDevice(torch.rand(4, 4, 3))
    assert moeEvents(prof) == []
