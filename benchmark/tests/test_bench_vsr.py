"""The IconVSR cell: its files found by name, its work counts and bounds
against hand arithmetic, its reference free of the program and of JAX,
its chain through the driver at a size a CPU test run can hold, and its
check failing the fp8 control on the card."""

import dataclasses
import time

import pytest

from benchmark.harness import guard, spec
from benchmark.harness.cell import Window, readMetrics, runCell, verdict
from benchmark.reference import iconvsr, vsrwork
from benchmark.reference.bounds import ITEM
from benchmark.reference.layers import fp8

CELL = "vsr_iconvsr_x4_540p"
PER_LAYER = {"k3_roofline.vsr", "k2_roofline.vsr", "mfu.vsr", "keyframes.vsr", "vsr_host_ms.vsr", "elementwise_ms.vsr",
             "device_idle.vsr"}
PEAK16, PEAK32, BYTES = 989e12, 67e12, 3.35e12


def tinyCell():
    """The cell at 40 x 48, 24 frames (a backward restart, the end of the stream's split batch of
    keyframe windows, the crop), one trunk block."""
    cell = spec.cell(CELL)
    return dataclasses.replace(cell, config=dict(cell.config, num_block=1),
                               traffic=dict(cell.traffic, width=48, height=40, frames=24, sample=2))


def test_cell_resolves_with_its_metrics():
    cell = spec.cell(CELL)
    assert [m["name"] for m in cell.endToEnd] == ["setup_s", "video_out_mpx_s"]
    assert {m["name"] for m in cell.perLayer} == PER_LAYER
    assert cell.config["entry"] == "vsr_chain" and cell.config["reduced"] == []
    assert (cell.traffic["width"], cell.traffic["height"], cell.traffic["frames"]) == (960, 540, 100)
    assert set(cell.limits["compare"]) == {"rms_lsb16", "max_lsb16"}
    assert callable(cell.driver().Driver)
    for m in cell.perLayer:
        assert m["moves"] == "video_out_mpx_s" and m["workloads"] == [CELL]


def test_reference_imports_neither_jax_nor_the_program():
    for name in ("iconvsr.py", "vsrwork.py"):
        tops = {guard.topLevel(m) for m in guard.imports(f"{guard.BENCH}/reference/{name}")}
        assert not tops & (guard.FORBIDDEN | {guard.PROGRAM}), (name, tops)
    assert guard.sourceFaults() == []


def _edvrMacs(h: int, w: int) -> float:
    """EDVR's multiply-adds on one 7-frame clip at h x w, by its layers."""
    n, c, hw = iconvsr.REF_TIME, iconvsr.NUM_FEAT, h * w
    k3 = c * c * 9  # a 3x3 conv at 64 channels, a pixel
    dcn = c * 216 * 9 + k3  # conv_offset to 3 dg 9 channels, then the contraction
    extract = n * hw * (3 * c * 9 + 10 * k3)
    down = n * (hw / 4) * 2 * k3 + n * (hw / 16) * 2 * k3
    l3 = n * (hw / 16) * (2 * k3 + k3 + dcn)  # offset_conv1 (128 in), offset_conv2, the DCN
    l2 = n * (hw / 4) * (2 * k3 + 2 * k3 + k3 + dcn + 2 * k3)  # offset_conv1..3, the DCN, feat_conv
    l1 = n * hw * (2 * k3 + 2 * k3 + k3 + dcn + 2 * k3)
    cas = n * hw * (2 * k3 + k3 + dcn)
    tsa = (hw * k3 + n * hw * k3 + 2 * hw * n * c * c  # the two temporal convs, feat_fusion and spatial_attn1 (1x1)
           + (hw / 4) * (2 * c * c + c * c + k3 + c * c)  # spatial_attn2 (1x1), _l1 (1x1), 3 (3x3), 4 (1x1)
           + (hw / 16) * (2 * k3 + k3)  # spatial_attn_l2, _l3
           + hw * (k3 + 2 * c * c))  # spatial_attn5, the two 1x1 add convs
    return extract + down + l3 + l2 + l1 + cas + tsa


def test_flops_by_hand():
    h = w = 64
    hw = h * w
    trunk = 60 * 64 * 64 * 9
    back, fwd = hw * (67 * 64 * 9 + trunk), hw * (131 * 64 * 9 + trunk)
    up = hw * (64 * 256 * 9 + 4 * 64 * 256 * 9 + 16 * 64 * 64 * 9 + 16 * 64 * 3 * 9)
    spy = 49 * (8 * 32 + 32 * 64 + 64 * 32 + 32 * 16 + 16 * 2) * sum(hw >> 2 * k for k in range(6))
    fusion = hw * 128 * 64 * 9
    p = vsrwork.partFlops(h, w)
    assert p == {"backward": 2 * back, "forward": 2 * fwd, "upsample": 2 * up, "spynet": 2 * spy, "fusion": 2 * fusion,
                 "edvr": pytest.approx(2 * _edvrMacs(h, w))}
    n, base = 100, 2 * (back + fwd + up)
    assert vsrwork.frameFlops(5, n, h, w) == base + 4 * spy  # both flows
    # a chunk's end: no backward flow (that step starts from zeros), a keyframe
    assert vsrwork.frameFlops(19, n, h, w) == pytest.approx(base + 2 * spy + p["edvr"] + 2 * p["fusion"])
    assert vsrwork.frameFlops(0, n, h, w) == pytest.approx(base + 2 * spy + p["edvr"] + 2 * p["fusion"])
    assert vsrwork.frameFlops(99, n, h, w) == pytest.approx(base + 2 * spy + p["edvr"] + 2 * p["fusion"])
    # an unaligned frame counts the aligned one's work times its share of it
    assert vsrwork.frameFlops(5, n, 60, 64) == pytest.approx((base + 4 * spy) * 60 / 64)


def test_bounds_by_hand():
    h, w = 540, 960
    # K3, bytes bound: x, 144 offsets, 72 mask values and the output in bf16 a pixel, the weights once a call
    px = 7 * h * w * (1 / 16 + 1 / 4 + 1 + 1)
    assert vsrwork.k3KeyframeBound(h, w, "bfloat16") == pytest.approx((688 * px + 4 * 73728) / BYTES)
    assert 688 / BYTES > 2 * 9 * 64 * 64 / PEAK16
    assert vsrwork.k3KeyframeBound(h, w, "bfloat16") == pytest.approx(1.7235e-3, rel=1e-4)
    # K2, bytes bound: each flow a pyramid of 3-channel bf16 warps (16 bytes a pixel) and one 64-channel fp32 warp
    pyramid = sum(16 * h * w / 4**k for k in range(6))
    both = 2 * (pyramid + (2 * 64 * 4 + 8) * h * w) / BYTES
    assert vsrwork.k2FrameBound(5, 100, h, w, "bfloat16") == pytest.approx(both)
    assert vsrwork.k2FrameBound(0, 100, h, w, "bfloat16") == pytest.approx(both / 2)
    assert vsrwork.k2FrameBound(19, 100, h, w, "bfloat16") == pytest.approx(both / 2)
    assert ITEM["bfloat16"] == 2 and (9 * 64 + 12) / PEAK32 < (2 * 64 * 4 + 8) / BYTES


def test_schedule():
    """A 100-frame job: every 7th frame, the four chunks that fill while
    frames arrive end at 19, 39, 59, 79; at the end of the stream the 17
    windows left that need no padding end at 96, the padded tail at 99."""
    keys = [t for t in range(100) if iconvsr.isKeyframe(t, 100)]
    assert keys == sorted(set(range(0, 100, 7)) | {19, 39, 59, 79, 96, 99}) and len(keys) == 21
    assert iconvsr.chunks(100) == [(0, 20), (20, 40), (40, 60), (60, 80), (80, 100)]


def test_chain_matches_the_reference(tmp_path):
    """24 frames of 40 x 48 through the driver: the route's chain from
    ``prepare``, the end of the stream as ``SR_vid`` signals it, the check
    against the reference, and the span and counter readers, fp32 on the
    CPU."""
    cell = tinyCell()
    run, _, numbers = runCell(cell, 2**31 + 11, 0.5, True, "cpu", time.perf_counter(), str(tmp_path))
    ok, checks = verdict(cell, run.window, numbers)
    assert ok and checks["rms_lsb16"]["value"] <= 0.25 and checks["max_lsb16"]["value"] <= 2, checks
    assert [i.frame for i in run.window.items] == list(range(24)) and run.window.failed == 0
    metrics = readMetrics(cell, run, True)
    assert metrics["keyframes.vsr"]["value"] == pytest.approx(7 / 24)
    assert metrics["vsr_host_ms.vsr"]["value"] > 0
    assert "k3_roofline.vsr" not in metrics  # no card, no kernel time


@pytest.mark.cuda
def test_control_fails_on_the_card(card, tmp_path):
    """The fp8 control at the cell's own size exceeds a limit (the full
    readings are taken by ``benchmark/tools/control.py``)."""
    cell = spec.cell(CELL)
    drv = cell.driver().Driver(cell, 2**31 + 1, card, str(tmp_path))
    drv.release()
    numbers = drv.check(drv.controlEntries(2, fp8))
    assert not verdict(cell, Window(0.0, 1.0, attempted=1), numbers)[0], numbers
