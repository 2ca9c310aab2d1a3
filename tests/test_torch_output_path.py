"""The output path on the device (``imageio.quantise``, ``imageio.toHost``
and ``pipeline/steps.procOutput``) against the host path it replaced:
``imageio.toOutput`` over the image copied to the host as float32, and for
video the channel flip and ``imageio.toBuffer`` after it.  Value for
value, in the dtype and shape the writer or the pipe gets."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from moephoto_tpu_torch.pipeline import steps
from moephoto_tpu_torch.utils import imageio
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
BITS = (8, 12, 16)
DTYPES = (torch.float32, torch.bfloat16)


def device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


def hostOutput(x, bits):
    """The replaced path: the image as float32 on the host, then ``toOutput``."""
    return imageio.toOutput(x.float().cpu().numpy(), bits)


def neighbours(t):
    """Each value and the next representable value either side of it."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype]
    bits = t.view(ints)
    return torch.cat([t, (bits + 1).view(t.dtype), (bits - 1).view(t.dtype)])


def edgeValues(bits, dtype, seed=0, width=1):
    """Exact multiples k * 2^-bits over the whole range and one ulp either
    side of each, values below 0 and above 1, infinities and random ones:
    an HWC image of ``width`` columns and 3 channels."""
    quant = 1 << bits
    k = np.unique(np.concatenate([np.arange(1, 300), np.arange(max(1, quant - 300), quant + 3),
                                  np.random.RandomState(seed).randint(1, quant, 600)]))
    grid = neighbours(torch.from_numpy((k / quant).astype(np.float32)).to(dtype))
    odd = torch.tensor([0.0, -0.0, -1e-8, -0.5, -2.0, 1.0, 1.5, 2.0, 1e6, float("inf"), float("-inf")])
    rand = torch.from_numpy(np.random.RandomState(seed + 1).uniform(-0.1, 1.1, 999).astype(np.float32))
    vals = torch.cat([grid.float(), odd, rand]).to(dtype)
    n = -(-vals.numel() // (3 * width)) * 3 * width
    vals = torch.cat([vals, vals[: n - vals.numel()]])
    return vals.reshape(-1, width, 3)


def imageOutput(bits):
    """The image route's output steps: quantise, copy, then the writer's array."""
    fs, ns, _ = steps.procOutput({}, dict(load=1, bitDepth=bits, channel=0, source=0, sf=1))
    assert len(fs) == len(ns) == 2
    return lambda x: fs[1](fs[0](x))


def videoOutput(bits, flip):
    """The video route's output steps of one frame: the pipe's bytes."""
    fs, ns, out = steps.procOutput({}, dict(load=1, bitDepth=bits, channel=int(not flip), source=1, sf=1))
    assert len(ns) == (4 if flip else 3) and out["channel"] == 1
    return lambda x: fs[0](x)[0]


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_quantise_matches_host_toOutput(dev, dtype, bits):
    """``quantise`` then the copy equal ``toOutput`` of the float32 copy,
    value for value and in its dtype, and the float input is unchanged."""
    x = edgeValues(bits, dtype).to(device(dev))
    before = x.clone()
    q = imageio.quantise(x, bits)
    assert q.device == x.device and q.element_size() == (1 if bits <= 8 else 2)
    got = imageio.fromQuantised(imageio.toHost(q), bits)
    want = hostOutput(x, bits)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert torch.equal(x, before)


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("bits", BITS)
def test_image_route_hands_the_writer_the_same_array(dev, bits):
    """The image route's array: ``toOutput``'s dtype, shape and values."""
    x = torch.from_numpy(np.random.RandomState(bits).uniform(-0.05, 1.05, (9, 14, 3)).astype(np.float32))
    x = x.to(device(dev))
    got = imageOutput(bits)(x)
    want = hostOutput(x, bits)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("bits", BITS)
def test_video_bytes_match_the_host_chain(dev, dtype, flip, bits):
    """The pipe's bytes equal ``toBuffer(toOutput(x)[..., ::-1])``, or
    ``toBuffer(toOutput(x))`` where the frame is BGR already."""
    x = edgeValues(bits, dtype, seed=bits, width=7).to(device(dev))
    arr = hostOutput(x, bits)
    want = imageio.toBuffer(arr[..., ::-1] if flip else arr, bits)
    got = videoOutput(bits, flip)(x)
    assert isinstance(got, bytes) and got == want


@pytest.mark.parametrize("dev", DEVICES)
def test_returned_arrays_are_not_reused(dev):
    """A first image's array is unchanged after a second request of the
    same shape: each array owns its memory."""
    d = device(dev)
    f = imageOutput(8)
    a, b = (torch.full((64, 48, 3), v, device=d) for v in (0.25, 0.75))
    first = f(a)
    kept = first.copy()
    second = f(b)
    np.testing.assert_array_equal(first, kept)
    assert first.ctypes.data != second.ctypes.data and not np.shares_memory(first, second)
    assert (first == 64).all() and (second == 192).all()


def moeEvents(prof):
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("moe.")]
    return [n for n, _, _ in sorted(out, key=lambda e: (e[1], -e[2]))]


@pytest.mark.parametrize("bits, flip", [(8, False), (16, True), (16, False)])
def test_out_bytes_counts_the_copy(bits, flip):
    """``moe.count.out_bytes=<n>`` once a frame, n = values x bytes a
    value (1 at 8 bits, 2 at 16), inside the ``toOutput`` span, beside the
    ``Channel`` and ``toBuffer`` spans."""
    x = torch.rand(10, 6, 3)
    f = videoOutput(bits, flip)
    n = x.numel() * (1 if bits <= 8 else 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(x)
    want = ["moe.step.output", "moe.step.toFloat"] + (["moe.step.Channel"] if flip else []) + [
        "moe.step.toOutput", f"moe.count.out_bytes={n}", "moe.step.toBuffer"]
    assert moeEvents(prof) == want


def test_out_bytes_counts_an_image():
    """The image route records the bytes once, before the writer's array
    widens 16-bit values to int32 on the host."""
    x = torch.rand(5, 7, 3)
    for bits, size in ((8, 1), (16, 2)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            arr = imageOutput(bits)(x)
        assert moeEvents(prof) == ["moe.step.toFloat", "moe.step.toOutput", f"moe.count.out_bytes={x.numel() * size}"]
        assert arr.dtype == (np.uint8 if bits == 8 else np.int32)
