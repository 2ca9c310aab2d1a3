"""The work counts and bounds against hand arithmetic, and the plain
references against the port at small sizes on the CPU."""

import pytest
import torch

from benchmark.reference import bounds, flops, ifrnet, lite
from benchmark.tests.helpers import runTiny

PEAK16, PEAK32, BYTES = 989e12, 67e12, 3.35e12


def test_lite_flops_by_hand():
    # MACs a low-resolution pixel of one plane: conv_input 48, conv_input2 48^2, three LB blocks of two 3x3
    # convs (FRM's pooled convs are per tile, not per pixel: 48*3*2 a plane), two up branches of a 1x1 conv
    # to 192 at 1x and at 2x (4 pixels), two 1x1 heads at 4x (16 pixels)
    h, w = 24, 40
    trunk = 48 + 48 * 48 + 3 * 2 * 9 * 48 * 48
    up = 2 * (48 * 192 + 4 * 48 * 192) + 2 * 16 * 48
    frm = 3 * 2 * 48 * 3
    per = trunk + up
    assert per == 220464
    assert flops.liteImageFlops(h, w, 3, 4) == 2 * 3 * (h * w * per + frm)


def test_ifrnet_flops_by_hand():
    h = w = 64
    chans = (3, 32, 48, 72, 96)
    enc = sum((h * w >> 2 * (l + 1)) * 9 * (chans[l] * chans[l + 1] + chans[l + 1] ** 2) for l in range(4))
    dec = 0
    for d, (cin, mid, cout) in enumerate(ifrnet.decoderChannels()):
        px = h * w >> 2 * (4 - d)
        dec += px * 9 * (cin * mid + 3 * mid * mid + 2 * 32 * 32) + px * mid * cout * 16
    assert flops.ifrnetFrameFlops(h, w) == 2 * (enc + dec)
    # an unaligned frame counts the aligned one's work times its share of it
    assert flops.ifrnetFrameFlops(60, 64) == pytest.approx(2 * (enc + dec) * 60 / 64)


def test_k1_bound_by_hand():
    M = 3 * 1080 * 1920
    macs = M * (2 * (4 + 16) * 48 * 48 + 16 * 2 * 48)
    weights = 2 * 2 * 4 * 48 * 48 * 2 + 2 * 2 * 5 * 48 * 4 + 2 * 49 * 4
    nbytes = 2 * M * 48 * 2 + M * 16 * 2 + weights
    assert bounds.k1ImageBound(1080, 1920, 3, 48, 2, "bfloat16") == pytest.approx(max(2 * macs / PEAK16, nbytes / BYTES))
    assert bounds.k1ImageBound(1080, 1920, 3, 48, 2, "bfloat16") == pytest.approx(1.17869e-3, rel=1e-4)


def test_k2_bound_by_hand():
    h, w = 1080, 1920
    hw = h * w
    # bytes bound every warp: the frames' two warps in fp32 with bf16 flows, the features' at 1/2, 1/4, 1/8
    nbytes = 2 * (hw * (2 * 3 * 4 + 2 * 2) + sum(hw / 4**l * (2 * c * 2 + 2 * 2) for l, c in ((1, 32), (2, 48), (3, 72))))
    assert bounds.k2FrameBound(h, w, ifrnet.WIDTHS, "bfloat16") == pytest.approx(nbytes / BYTES)
    assert bounds.warpBound(10, 10, 64, 4, 4) == pytest.approx(max((2 * 100 * 64 * 4 + 800) / BYTES,
                                                                   100 * (9 * 64 + 12) / PEAK32))


def test_lite_tiler_matches_the_port_across_tiles():
    """Several tiles, their halos and the blend: the port's tiled executor
    and the reference tiler on one image, fp32 on the CPU."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.engine.tiling import TileSpec
    from moephoto_tpu_torch.models.sr import moeNetLite2x4

    from benchmark.harness.weights import drawWeights

    torch.manual_seed(0)
    ref = lite.MoeNetLite2(4)
    sd = drawWeights(ref, {"gain": 1.0, "bias_std": 0.01}, 11, "cpu", torch.float32)
    ref.load_state_dict(sd)
    port = moeNetLite2x4()
    port.load_state_dict(sd)
    spec = dict(tile=32, pad=5, align=8, scale=4)
    img = torch.rand(48, 64, 3)
    ex = ModelExec(port.eval(), TileSpec(32, 5, 8, 4, 4), channelSplit=True, dtype=torch.float32, device="cpu")
    got = ex(img)
    with torch.no_grad():
        want = lite.tiled(img.permute(2, 0, 1), ref, **spec).permute(1, 2, 0)
    assert got.shape == want.shape == (192, 256, 3)
    assert (got - want).abs().max() < 1e-4


def test_lite_chain_matches_the_reference(tmp_path):
    ok, checks, _ = runTiny("sr_lite4_1080p", tmp_path)  # 64x48 images through the route's chain
    assert ok and checks["rms_lsb8"]["value"] <= 0.1 and checks["max_lsb8"]["value"] <= 1


def test_ifrnet_chain_matches_the_reference(tmp_path, monkeypatch):
    from benchmark.tests import helpers

    monkeypatch.setitem(helpers.TINY, "clip", dict(helpers.TINY["clip"], height=64))
    ok, checks, run = runTiny("slomo_ifrnet_m_1080p", tmp_path)  # 64x64 frames through the video chain
    assert ok and checks["originals_differing"]["value"] == 0
    assert checks["rms_lsb16"]["value"] <= 2 and checks["max_lsb16"]["value"] <= 8
    assert run.window.attempted == len(run.window.items) > 0


def test_ifrnet_pair_matches_the_port():
    """One pair through the port's model and the reference, fp32."""
    from moephoto_tpu_torch.models.ifrnet import IFRNet

    from benchmark.harness.weights import drawWeights

    ref = ifrnet.IFRNetM()
    sd = drawWeights(ref, {"gain": 1.0, "bias_std": 0.1, "prelu": [0.25, 0.05]}, 3, "cpu", torch.float32)
    ref.load_state_dict(sd)
    port = IFRNet("M")
    port.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    frames = torch.rand(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        m, inpN, feats = port.encodeFull(frames)
        pred = port.decodePost([f.reshape(1, 2, *f.shape[1:]) for f in feats], torch.tensor([[0.5]]),
                               inpN[None], m.reshape(1, 2, 1, 1, 1))[0, 0]
        want = ref(frames[:1].permute(0, 3, 1, 2), frames[1:].permute(0, 3, 1, 2), 0.5)[0].permute(1, 2, 0)
    assert (pred - want).abs().max() < 1e-4
