"""The MPRNet deblurring cell: its files found by name, its FLOP count
against hand arithmetic, its reference free of the program and of JAX,
its kernel classes, its chain through the driver at a size a CPU test run
can hold, and its check failing the fp8 control on the card (at the cut
widths a CPU run can hold, the fp8 control's error is a fraction of the
whole model's, so the cell's limits are not for it)."""

import dataclasses
import functools
import time

import pytest

from benchmark.harness import guard, spec
from benchmark.harness import trace as tracing
from benchmark.harness.cell import Item, Run, Window, readMetrics, runCell, verdict
from benchmark.reference import deblurwork
from benchmark.reference.layers import fp8

CELL = "deblur_mprnet_1080p"
PER_LAYER = {"mprnet_host_ms.deblur", "pool_ms.deblur", "elementwise_ms.deblur", "mfu.deblur", "launches.deblur",
             "device_idle.deblur"}
SMALL = {"n_feat": 16, "scale_unetfeats": 8, "scale_orsnetfeats": 8, "num_cab": 2}
TILES = {"tile": 64, "pad": 8, "align": 8, "scale": 1, "batch": 2}


@pytest.fixture
def tinyCell(monkeypatch):
    """The cell at widths 16/8/8 and 2 CABs an ORB, on 112 x 80 photos in
    tiles of 64 (2 x 2 tiles in two chunks, the reflect pad); the
    program's registry entry cut to the same."""
    from moephoto_tpu_torch.engine.tiling import TileSpec
    from moephoto_tpu_torch.models import mprnet
    from moephoto_tpu_torch.pipeline import registry

    monkeypatch.setattr(mprnet, "mprNet", functools.partial(mprnet.MPRNet, 16, 8, 8, 2))
    monkeypatch.setitem(registry.DEHAZE_REGISTRY, "MPRNet_deblurring",
                        dict(registry.DEHAZE_REGISTRY["MPRNet_deblurring"], spec=TileSpec(64, 8, 8, 1.0, 2)))
    cell = spec.cell(CELL)
    return dataclasses.replace(cell, config=dict(cell.config, **SMALL, tile_spec=TILES),
                               traffic={"kind": "images", "pool": 2, "sizes": [[112, 80]], "sample": 2})


def test_cell_resolves_with_its_metrics():
    cell = spec.cell(CELL)
    assert [m["name"] for m in cell.endToEnd] == ["setup_s", "image_mpx_s"]
    assert {m["name"] for m in cell.perLayer} == PER_LAYER
    assert cell.config["entry"] == "deblur_chain" and cell.config["reduced"] == []
    assert cell.config["steps"] == [{"op": "dehaze", "model": "MPRNet_deblurring"}]
    assert cell.traffic["sizes"] == [[1920, 1080]]
    assert set(cell.limits["compare"]) == {"rms_lsb8", "max_lsb8"}
    assert callable(cell.driver().Driver)
    for m in cell.perLayer:
        assert m["moves"] == "image_mpx_s" and m["workloads"] == [CELL]


def test_configuration_matches_the_registry():
    """The configuration's widths and tile spec are the program's
    MPRNet_deblurring, at the published defaults."""
    from moephoto_tpu_torch.models import mprnet
    from moephoto_tpu_torch.pipeline import registry

    cfg = spec.cell(CELL).config
    entry = registry.DEHAZE_REGISTRY["MPRNet_deblurring"]
    s = entry["spec"]
    assert cfg["tile_spec"] == {"tile": s.tile, "pad": s.pad, "align": s.align, "scale": s.scale, "batch": s.batch}
    assert not entry["channelSplit"] and entry["path"] == "model/" + cfg["checkpoint"]
    assert entry["fn"] == "mprNet" and mprnet.mprNet is mprnet.MPRNet
    model = mprnet.MPRNet()
    assert (len(model.shallow_feat[0][1][0].weight), model.encoder[0].encoder[1][1][0].weight.shape[0],
            model.encoder[2].orb[0][0][0].weight.shape[0], len(model.encoder[2].orb[0]) - 1) == (
        cfg["n_feat"], cfg["n_feat"] + cfg["scale_unetfeats"], cfg["n_feat"] + cfg["scale_orsnetfeats"],
        cfg["num_cab"])
    assert mprnet.CA_REDUCTION == cfg["reduction"] and not cfg["bias"]


def test_reference_imports_neither_jax_nor_the_program():
    for name in ("mprnet.py", "deblurwork.py"):
        tops = {guard.topLevel(m) for m in guard.imports(f"{guard.BENCH}/reference/{name}")}
        assert not tops & (guard.FORBIDDEN | {guard.PROGRAM}), (name, tops)
    assert guard.sourceFaults() == []


def test_flops_by_hand():
    """The published widths on a 64 x 64 image: ~11.6 M MACs an input
    pixel, and each channel attention's two 1x1 convs once a patch (a
    quadrant, a half or the image)."""
    h = w = 64
    n, s, o, m = 96, 48, 32, 8
    w0, w1, w2, wo = n, n + s, n + 2 * s, n + o
    cab = lambda c: 18 * c * c  # two 3x3 convs
    shallow = 27 * n + cab(n)  # conv 3 -> n and a CAB
    enc = 2 * cab(w0) + w0 * w1 / 4 + 2 * cab(w1) / 4 + w1 * w2 / 16 + 2 * cab(w2) / 16  # levels and Downs
    dec = (2 * cab(w2) / 16 + w2 * w1 / 4 + cab(w1) / 4 + 2 * cab(w1) / 4  # level 3, Up, skip CAB, level 2
           + w1 * w0 + cab(w0) + 2 * cab(w0))  # Up, skip CAB, level 1
    csff = 2 * (w0 * w0 + w1 * w1 / 4 + w2 * w2 / 16)
    sam = n * n + 3 * n + 3 * n
    concat = 9 * 2 * n * n + 9 * 2 * n * wo
    orsnet = 3 * (m * cab(wo) + 9 * wo * wo)
    fuse = 2 * (w0 * wo + (w1 * w0 + w0 * wo) + (w2 * w1 / 4 + w1 * w0 + w0 * wo))  # Ups, then n -> n + o
    per = 3 * shallow + 2 * enc + 2 * dec + csff + 2 * sam + concat + orsnet + fuse + 9 * wo * 3
    # the attentions' c -> c/4 -> c, once a patch: CABs at each width, counted a patch
    cas = {w0: 4 * 1 + 4 * 2 + 2 * 3 + 2 * 1 + 2 * 2 + 3 + 1, w1: 4 * 2 + 2 * 3 + 2 * 2 + 3,
           w2: 4 * 2 + 2 * 2 + 2 * 2 + 2, wo: 3 * m}
    ca = sum(c * c // 2 * k for c, k in cas.items())
    assert per == 11587680
    assert deblurwork.imageFlops(h, w) == pytest.approx(2 * (per * h * w + ca))
    # an unaligned image counts the aligned one's work times its share of it
    assert deblurwork.imageFlops(60, 64) == pytest.approx(deblurwork.imageFlops(64, 64) * 60 / 64)
    assert deblurwork.imageFlops(1080, 1920) == pytest.approx(4.806e13, rel=1e-3)


def test_kernel_classes():
    """The attention's fp32 means count in pool_ms.deblur alone; cuBLASLt's
    GEMMs, cuDNN's convs and K7 in neither it nor elementwise_ms.deblur."""
    cell = spec.cell(CELL)
    names = {"void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, at::native::MeanOps<"
             "c10::BFloat16, float, float, float>, unsigned int, float, 4, 4> >": 1,
             "nvjet_tst_128x64_64x8_1x2_h_bz_TNT": 2,
             "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64": 4,
             "void (anonymous namespace)::blendKernel<__nv_bfloat16>": 8,
             "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
             "at::native::CUDAFunctor_add<c10::BFloat16> >": 16,
             "void at::native::(anonymous namespace)::upsample_bilinear2d_nhwc_out_frame<c10::BFloat16, float>": 32,
             "Memcpy HtoD (Pageable -> Device)": 64}
    device, t = [], 0.0
    for name, ms in names.items():
        device.append((name, t, t + ms * 1e-3))
        t += ms * 1e-3
    run = Run(0.0, Window(0.0, 1.0, items=[Item(0.0, 1.0)]), tracing.Trace((0.0, 1.0), device))
    assert cell.reader("pool_ms.deblur").read(run) == pytest.approx(1)
    assert cell.reader("elementwise_ms.deblur").read(run) == pytest.approx(48)
    assert cell.reader("launches.deblur").read(run) == 6
    assert cell.reader("mprnet_host_ms.deblur").read(run) is None  # no moe.mprnet.* span: left out
    assert cell.reader("mfu.deblur").read(run) is None  # no work counted


def test_chain_matches_the_reference(tinyCell, tmp_path):
    """Two photos through the driver: the route's chain with the dehaze
    step, the check against the reference, and the span and work readers,
    fp32 on the CPU."""
    run, _, numbers = runCell(tinyCell, 2**33 + 5, 0.5, True, "cpu", time.perf_counter(), str(tmp_path))
    ok, checks = verdict(tinyCell, run.window, numbers)
    assert ok and checks["rms_lsb8"]["value"] <= 0.1 and checks["max_lsb8"]["value"] <= 1, checks
    assert run.window.failed == 0 and all(i.inPx == i.outPx == 112 * 80 for i in run.window.items)
    metrics = readMetrics(tinyCell, run, True)
    assert metrics["mprnet_host_ms.deblur"]["value"] > 0 and metrics["mfu.deblur"]["value"] > 0


@pytest.mark.cuda
def test_control_fails_on_the_card(card, tmp_path):
    """The fp8 control at the cell's own size exceeds a limit (the full
    readings are taken by ``benchmark/tools/control.py``)."""
    cell = spec.cell(CELL)
    drv = cell.driver().Driver(cell, 2**31 + 1, card, str(tmp_path))
    drv.release()
    numbers = drv.check(drv.controlEntries(2, fp8))
    assert not verdict(cell, Window(0.0, 1.0, attempted=1), numbers)[0], numbers
