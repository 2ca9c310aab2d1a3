"""The NAFNet denoising cell: its files found by name, its FLOP count
against hand arithmetic, its reference free of the program and of JAX,
its kernel classes, its chain through the driver at a size a CPU test
run can hold, and its check failing the fp8 control on the card (at the
cut stack a CPU run can hold, the fp8 control's error is a fraction of
the whole model's, so the cell's limits are not for it)."""

import dataclasses
import functools
import time

import pytest

from benchmark.harness import guard, spec
from benchmark.harness import trace as tracing
from benchmark.harness.cell import Item, Run, Window, readMetrics, runCell, verdict
from benchmark.reference import dnwork
from benchmark.reference.layers import fp8

CELL = "dn_nafnet32_1080p"
PER_LAYER = {"nafnet_host_ms.dn", "norm_ms.dn", "elementwise_ms.dn", "launches.dn", "device_idle.dn", "mfu.dn"}
SHORT = {"enc_blk_nums": [1, 1, 1, 1], "middle_blk_num": 2, "dec_blk_nums": [1, 1, 1, 1]}
TILES = {"tile": 64, "pad": 8, "align": 16, "scale": 1, "batch": 3}


@pytest.fixture
def tinyCell(monkeypatch):
    """The cell at one block a level and 2 middle blocks, on 112 x 80
    photos in tiles of 64 (2 x 2 tiles, a padded chunk, the reflect pad);
    the program's registry entry cut to the same."""
    from moephoto_tpu_torch.engine.tiling import TileSpec
    from moephoto_tpu_torch.models import nafnet
    from moephoto_tpu_torch.pipeline import registry

    monkeypatch.setattr(nafnet, "nafNetSIDD32", functools.partial(nafnet.NAFNet, 32, 2, (1, 1, 1, 1), (1, 1, 1, 1)))
    monkeypatch.setitem(registry.DN_REGISTRY, "NAFNet_32",
                        dict(registry.DN_REGISTRY["NAFNet_32"], spec=TileSpec(64, 8, 16, 1.0, 3)))
    cell = spec.cell(CELL)
    return dataclasses.replace(cell, config=dict(cell.config, **SHORT, tile_spec=TILES),
                               traffic={"kind": "images", "pool": 2, "sizes": [[112, 80]], "sample": 2})


def test_cell_resolves_with_its_metrics():
    cell = spec.cell(CELL)
    assert [m["name"] for m in cell.endToEnd] == ["setup_s", "image_mpx_s"]
    assert {m["name"] for m in cell.perLayer} == PER_LAYER
    assert cell.config["entry"] == "dn_chain" and cell.config["reduced"] == []
    assert cell.config["steps"] == [{"op": "DN", "model": "NAFNet_32"}]
    assert cell.traffic["sizes"] == [[1920, 1080]]
    assert set(cell.limits["compare"]) == {"rms_lsb8", "max_lsb8"}
    assert callable(cell.driver().Driver)
    for m in cell.perLayer:
        assert m["moves"] == "image_mpx_s" and m["workloads"] == [CELL]


def test_configuration_matches_the_registry():
    """The configuration's sizes and tile spec are the program's NAFNet_32."""
    from moephoto_tpu_torch.models import nafnet
    from moephoto_tpu_torch.pipeline import registry

    cfg = spec.cell(CELL).config
    entry = registry.DN_REGISTRY["NAFNet_32"]
    s = entry["spec"]
    assert cfg["tile_spec"] == {"tile": s.tile, "pad": s.pad, "align": s.align, "scale": s.scale, "batch": s.batch}
    assert not entry["channelSplit"] and entry["path"] == "model/" + cfg["checkpoint"]
    assert nafnet.nafNetSIDD32.args == (cfg["width"], cfg["middle_blk_num"], tuple(cfg["enc_blk_nums"]),
                                        tuple(cfg["dec_blk_nums"]))


def test_reference_imports_neither_jax_nor_the_program():
    for name in ("nafnet.py", "dnwork.py"):
        tops = {guard.topLevel(m) for m in guard.imports(f"{guard.BENCH}/reference/{name}")}
        assert not tops & (guard.FORBIDDEN | {guard.PROGRAM}), (name, tops)
    assert guard.sourceFaults() == []


def _blockMacs(c: int) -> int:
    """A NAFBlock's multiply-adds a pixel at c channels: conv1 c -> 2c, the
    depthwise 3x3 on 2c, conv3 c -> c, conv4 c -> 2c, conv5 c -> c."""
    return 2 * c * c + 2 * c * 9 + c * c + 2 * c * c + c * c


def test_flops_by_hand():
    """SIDD-32 on a 64 x 64 image: ~245 k MACs an input pixel, and SCA's
    1x1 conv once an image for each block."""
    h = w = 64
    enc, dec, middle = (2, 2, 4, 8), (2, 2, 2, 2), 12
    per, sca = 32 * 27 + 3 * 32 * 9, 0  # intro and ending
    for i in range(4):
        c, n = 32 << i, enc[i] + dec[3 - i]
        per += n * _blockMacs(c) / 4**i + 2 * (8 * c * c) / 4 ** (i + 1)  # blocks, the down and the up
        sca += n * c * c
    per += middle * _blockMacs(512) / 256
    sca += middle * 512 * 512
    assert round(per) == 244768
    assert dnwork.imageFlops(h, w) == pytest.approx(2 * (per * h * w + sca))
    # an unaligned image counts the aligned one's work times its share of it
    assert dnwork.imageFlops(60, 64) == pytest.approx(dnwork.imageFlops(64, 64) * 60 / 64)
    assert dnwork.imageFlops(1080, 1920) == pytest.approx(1.015e12, rel=1e-3)


def test_kernel_classes():
    """Layer norm's kernels count in norm_ms.dn alone; cuBLASLt's GEMMs,
    cuDNN's depthwise conv and K7 in neither it nor elementwise_ms.dn."""
    cell = spec.cell(CELL)
    names = {"void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float, false>": 1,
             "nvjet_tst_128x64_64x8_1x2_h_bz_TNT": 2, "conv2d_c1_k1_nhwc": 4,
             "void (anonymous namespace)::blendKernel<__nv_bfloat16>": 8,
             "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
             "at::native::CUDAFunctor_add<c10::BFloat16> >": 16,
             "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, at::native::MeanOps": 32,
             "Memcpy HtoD (Pageable -> Device)": 64}
    device, t = [], 0.0
    for name, ms in names.items():
        device.append((name, t, t + ms * 1e-3))
        t += ms * 1e-3
    run = Run(0.0, Window(0.0, 1.0, items=[Item(0.0, 1.0)]), tracing.Trace((0.0, 1.0), device))
    assert cell.reader("norm_ms.dn").read(run) == pytest.approx(1)
    assert cell.reader("elementwise_ms.dn").read(run) == pytest.approx(48)
    assert cell.reader("launches.dn").read(run) == 6
    assert cell.reader("nafnet_host_ms.dn").read(run) is None  # no moe.nafnet.* span: left out


def test_chain_matches_the_reference(tinyCell, tmp_path):
    """Two photos through the driver: the route's chain with the DN step,
    the check against the reference, and the span reader, fp32 on the CPU."""
    run, _, numbers = runCell(tinyCell, 2**33 + 5, 0.5, True, "cpu", time.perf_counter(), str(tmp_path))
    ok, checks = verdict(tinyCell, run.window, numbers)
    assert ok and checks["rms_lsb8"]["value"] <= 0.1 and checks["max_lsb8"]["value"] <= 1, checks
    assert run.window.failed == 0 and all(i.inPx == i.outPx == 112 * 80 for i in run.window.items)
    metrics = readMetrics(tinyCell, run, True)
    assert metrics["nafnet_host_ms.dn"]["value"] > 0 and metrics["mfu.dn"]["value"] > 0


@pytest.mark.cuda
def test_control_fails_on_the_card(card, tmp_path):
    """The fp8 control at the cell's own size exceeds a limit (the full
    readings are taken by ``benchmark/tools/control.py``)."""
    cell = spec.cell(CELL)
    drv = cell.driver().Driver(cell, 2**31 + 1, card, str(tmp_path))
    drv.release()
    numbers = drv.check(drv.controlEntries(2, fp8))
    assert not verdict(cell, Window(0.0, 1.0, attempted=1), numbers)[0], numbers
