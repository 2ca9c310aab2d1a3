"""The port's MPRNet (``moephoto_tpu_torch/models/mprnet.py``) and the
dehaze step's chain around it (``registry.getDehaze`` -> ``ModelExec`` ->
the tiler) against the benchmark's plain reference
(``benchmark/reference/mprnet.py``) on the CPU in fp32, with weights drawn
by the benchmark cell's own rule (``benchmark/configs/mprnet_gopro96.json``)
at widths 16/8/8 and 2 CABs an ORB, and once at the published widths on
one 64 x 64 tile; ``stages()`` chained against ``forward``; four planted
faults that the comparison must catch; the reference's departures from
the published MPRNet; the three ``moe.mprnet.*`` spans.

Tolerances, both sides fp32 and computing the same operations on the same
patches (the port batches the quadrants and the halves, the reference
runs each alone, as published): 1e-4 absolute on outputs in [0, 1] and on
the tiled image, since ~60 layers of fp32 rounding (1e-7 relative each)
on features of magnitude up to ~30 stay two orders below it, while each
planted fault moves outputs by 1e-3 or more; the 8-bit outputs within 1
step, since the output step truncates and a value at a step's edge moves
one step for a difference of 1e-7.
"""

import functools
import json
import os

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import spec
from benchmark.harness import trace as tracing
from benchmark.harness.cell import Item, Run, Window
from benchmark.harness.traffic import picture
from benchmark.harness.weights import drawWeights
from benchmark.reference import lite
from benchmark.reference import mprnet as R
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.engine.tiling import TileSpec
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import mprnet as P
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (16, 8, 8, 2)  # n_feat, scale_unetfeats, scale_orsnetfeats, num_cab
GOPRO96 = (96, 48, 32, 8)
SPEC = {"tile": 64, "pad": 8, "align": 8, "scale": 1, "batch": 2}
H, W, SEED = 80, 112, 2**31 + 24
TOL, LSB_MAX = 1e-4, 1


def _rule():
    with open(os.path.join(ROOT, "benchmark", "configs", "mprnet_gopro96.json")) as fp:
        return json.load(fp)["weights"]


def _pair(sizes, seed):
    """(reference, port) with one set of weights drawn by the cell's rule."""
    ref = R.MPRNet(*sizes)
    sd = drawWeights(ref, _rule(), seed, "cpu", torch.float32)
    ref.load_state_dict(sd, strict=True)
    port = P.MPRNet(*sizes)
    port.load_state_dict(sd, strict=True)
    return ref.eval(), port.eval(), sd


@pytest.fixture(scope="module")
def models():
    return _pair(SMALL, SEED)


@pytest.fixture(scope="module")
def image():
    """An 80 x 112 uint8 photo: 2 x 2 tiles of 64 at pad 8, the height
    reflect-padded to 96, two chunks of 2 tiles."""
    x = picture(torch.Generator().manual_seed(SEED), H, W, "cpu")
    return (x * 255).round().to(torch.uint8).permute(1, 2, 0).contiguous().numpy()


def _port(model):
    return lambda x: model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol, err


@pytest.fixture
def deblurStep(tmp_path, monkeypatch):
    """``registry.getDehaze`` for ``MPRNet_deblurring`` at the small widths
    and the small tile spec, on the CPU in fp32, its checkpoint under a
    fresh model directory: a function of the weights to the step's
    ``ModelExec``."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "modelDir", str(tmp_path))
    monkeypatch.setattr(P, "mprNet", functools.partial(P.MPRNet, *SMALL))
    entry = dict(registry.DEHAZE_REGISTRY["MPRNet_deblurring"],
                 spec=TileSpec(SPEC["tile"], SPEC["pad"], SPEC["align"], 1.0, SPEC["batch"]))
    monkeypatch.setitem(registry.DEHAZE_REGISTRY, "MPRNet_deblurring", entry)

    def make(sd):
        registry._modelCache.clear()
        registry._paramsCache.clear()
        path = tmp_path / "MPRNet" / "model_deblurring.pth"
        path.parent.mkdir(exist_ok=True)
        torch.save(sd, path)
        ex = registry.getDehaze({"model": "MPRNet_deblurring"})
        assert ex.dtype == torch.float32 and not ex.channelSplit
        return ex

    yield make
    registry._modelCache.clear()
    registry._paramsCache.clear()


def _chain(ex, image):
    """The dehaze step's float result and the 8-bit output the chain writes."""
    x = torch.from_numpy(image).float() / 255.0
    y = ex(x)
    return y, lite.toOutput8(y)


def _want(ref, image):
    x = torch.from_numpy(image).permute(2, 0, 1).float() / 255.0
    with torch.no_grad():
        y = R.tiledRGB(x, ref, SPEC["tile"], SPEC["pad"], SPEC["align"], SPEC["batch"]).permute(1, 2, 0)
    return y, R.deblurImage(ref, image, SPEC, "cpu")


def test_blocks_match_the_port(models):
    """A CAB at 24 channels, a SAM, and the small model on two tiles whose
    height and width differ (a join along H told from one along W)."""
    ref, port, _ = models
    x = torch.rand(2, 3, 64, 48, generator=torch.Generator().manual_seed(1))
    f = torch.randn(2, 24, 16, 12, generator=torch.Generator().manual_seed(2))
    img = torch.rand(2, 3, 16, 12, generator=torch.Generator().manual_seed(3))
    g = torch.randn(2, 16, 16, 12, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        cab = ref.encoder[0].encoder[1][1]
        _close(port.encoder[0].encoder[1][1](f), cab(f), 1e-4 * float(cab(f).abs().max()))
        for a, b in zip(port.sam[0](g, img), ref.sam[0](g, img)):
            _close(a, b)
        want = ref(x)
        _close(_port(port)(x), want)
        assert float((want - x).square().mean().sqrt()) > 0.02  # the stages add a residual


def test_published_widths_match_the_port():
    """The published widths (96/48/32, 8 CABs an ORB, 55 CABs) on one
    64 x 64 tile: 8 x 8 at level 3 of a quadrant."""
    ref, port, _ = _pair(GOPRO96, SEED + 1)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _close(_port(port)(x), ref(x))
    assert sum(isinstance(m, P.CAB) for m in port.modules()) == 55


def test_stages_chain_to_forward(models):
    """``stages()`` run one after another is ``forward``, bit for bit, and
    each stage takes what the one before returned."""
    _, port, _ = models
    x = torch.rand(3, 48, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        state = x
        for _, fn in port.stages():
            state = fn(state)
        assert torch.equal(state, port(x))
    assert [n for n, _ in port.stages()] == ["moe.mprnet.stage1", "moe.mprnet.stage2", "moe.mprnet.stage3"]


def test_deblur_step_matches_deblur_image(models, image, deblurStep):
    """The dehaze step's ``ModelExec`` on 80 x 112: four tiles in two
    chunks, the reflect pad, the blend; against the reference's tiler and
    ``deblurImage``."""
    ref, _, sd = models
    got, got8 = _chain(deblurStep(sd), image)
    want, want8 = _want(ref, image)
    _close(got, want)
    d = got8.float() - want8.float()
    assert float(d.abs().max()) <= LSB_MAX and float(d.square().mean().sqrt()) < 0.1


def _fails(got, want):
    return float((got - want).abs().max()) > TOL


def _wholeTileStage1(self, inp):
    """Stage 1 on the whole tile: the tile's features split into halves
    instead of each quadrant encoded alone."""
    x3 = inp.permute(0, 3, 1, 2)
    h = x3.shape[2]
    halves = torch.cat([x3[:, :, : h // 2], x3[:, :, h // 2:]])
    enc = [torch.cat([f[:, :, : f.shape[2] // 2], f[:, :, f.shape[2] // 2:]])
           for f in self.encoder[0](self.shallow_feat[0](x3))]
    dec = self.decoder[0](enc)
    return x3, halves, enc, dec, self.sam[0](dec[0], halves)[0]


def _zeroGate(self, x, xImg):
    return self.conv1(x) * 0.0 + x, self.conv2(x) + xImg


@pytest.mark.parametrize("fault", ["whole_tile_stage1", "align_corners", "zeroed_sam_gate"])
def test_planted_fault_fails(models, image, deblurStep, monkeypatch, fault):
    ref, _, sd = models
    if fault == "whole_tile_stage1":
        monkeypatch.setattr(P.MPRNet, "_stage1", _wholeTileStage1)
    elif fault == "align_corners":
        monkeypatch.setattr(P, "interpolateScale", functools.partial(PA.interpolateScale, align_corners=True))
    else:
        monkeypatch.setattr(P.SAM, "forward", _zeroGate)
    assert _fails(_chain(deblurStep(sd), image)[0], _want(ref, image)[0])


def test_whole_image_pooling_fails(models, image, deblurStep):
    """The image run whole, as the published model runs it: the channel
    attention then pools over the image's quadrants, halves and whole, not
    over each tile's."""
    ref, _, sd = models
    x = torch.from_numpy(image).float() / 255.0
    assert _fails(deblurStep(sd).applyWhole(x), _want(ref, image)[0])


def test_reflect_pad_not_zero_pad(models):
    """A 40 x 52 image is one tile, reflect-padded to 40 x 56 and cropped;
    zeros in the pad give another result."""
    ref, _, _ = models
    x = torch.rand(3, 40, 52, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = R.tiledRGB(x, ref, SPEC["tile"], SPEC["pad"], SPEC["align"])
        refl = ref(F.pad(x[None], (0, 4, 0, 0), mode="reflect"))[0, :, :, :52]
        zero = ref(F.pad(x[None], (0, 4, 0, 0)))[0, :, :, :52]
    _close(got, refl, 1e-6)
    assert float((zero - refl).abs().max()) > 1e-3


def test_only_the_last_stage_clamped(models):
    """The reference returns stage 3's image clamped to [0, 1]: tail plus
    the input, where the published model returns three images, unclamped."""
    ref, _, _ = models
    x = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(7))
    out = {}
    hook = ref.tail.register_forward_hook(lambda m, i, o: out.update(tail=o))
    with torch.no_grad():
        y = ref(x)
    hook.remove()
    unclamped = out["tail"] + x
    assert float(unclamped.min()) < 0 or float(unclamped.max()) > 1
    assert torch.equal(y, unclamped.clamp(0.0, 1.0))


def test_one_prelu_slope_for_every_cab(models):
    """The cell's draw gives every CAB's PReLU the one slope 0.25, so the
    reference's slopes a CAB compute the published model's shared ``act``."""
    _, _, sd = models
    slopes = [v for k, v in sd.items() if k.endswith(".1.weight") and v.numel() == 1]
    assert len(slopes) == sum(isinstance(m, R.CAB) for m in R.MPRNet(*SMALL).modules())
    assert all(float(v) == 0.25 for v in slopes)


def test_spans_once_a_model_call(models, image, deblurStep):
    """The CPU profiler records ``moe.mprnet.stage1``, ``.stage2`` and
    ``.stage3`` once each a model call (two chunks), nested in order in
    ``moe.engine.chunk``; the benchmark's ``mprnet_host_ms.deblur`` reads
    them."""
    _, _, sd = models
    ex = deblurStep(sd)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            _chain(ex, image)
    tr = tracing.fromProfiler(prof)
    spans = sorted((s, n) for n, s, _ in tr.host if n.startswith("moe.mprnet.") or n == "moe.engine.chunk")
    stages = ["moe.mprnet.stage1", "moe.mprnet.stage2", "moe.mprnet.stage3"]
    assert [n for _, n in spans] == (["moe.engine.chunk"] + stages) * 2
    run = Run(0.0, Window(*tr.window, items=[Item(0.0, 1.0)]), tr)
    ms = spec.cell("deblur_mprnet_1080p").reader("mprnet_host_ms.deblur").read(run)
    assert 0 < ms <= 1e3 * tr.window_s


def test_spans_cost_nothing_when_off():
    """Without a profiler the model records no range: a span is the shared
    no-op context."""
    from moephoto_tpu_torch import progress

    assert not torch.autograd._profiler_enabled()
    assert progress.span("moe.mprnet.stage1") is progress.span("moe.mprnet.stage3")


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["MPRNet_deblurring", "MPRNet_denoising", "MPRNet_deraining"])
def test_stage_graphs_match_eager_on_the_card(key):
    """On the card ``ModelExec`` replays a full chunk of each MPRNet entry
    (its published widths, its registry tile spec) as three CUDA graphs in
    bf16: bit-equal to the same exec run eagerly (the model behind a
    function without stages); one capture for two images."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    entry = {**registry.DN_REGISTRY, **registry.DEHAZE_REGISTRY}[key]
    port = getattr(P, entry["fn"])()
    port.load_state_dict(drawWeights(R.MPRNet(*_widths(port)), _rule(), SEED, "cpu", torch.float32), strict=True)
    port = port.to("cuda", torch.bfloat16).eval().to(memory_format=torch.channels_last)
    spec_ = entry["spec"]
    ex = ModelExec(port, spec_, dtype=torch.bfloat16, device="cuda")
    eager = ModelExec(lambda t: port(t), spec_, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    side = 2 * spec_.tile - 2 * spec_.pad  # two tiles a side: one full chunk or more
    a, b = (torch.rand(side, side * spec_.batch // 2 + 16, 3, generator=g, device="cuda") for _ in range(2))
    ga, gb = ex(a), ex(b)
    graphs = ex._graphs
    assert graphs is not None and [n for n, _ in graphs.graphs] == [n for n, _ in port.stages()]
    ea, eb = eager(a), eager(b)
    assert ex._graphs is graphs
    assert torch.equal(ga, ea) and torch.equal(gb, eb) and not torch.equal(ga, gb)


def _widths(model: P.MPRNet):
    """(n_feat, scale_unetfeats, scale_orsnetfeats, num_cab) of a port model."""
    n = model.shallow_feat[0][0].weight.shape[0]
    s = model.encoder[0].encoder[1][1][0].weight.shape[0] - n
    o = model.encoder[2].orb[0][0][0].weight.shape[0] - n
    return n, s, o, len(model.encoder[2].orb[0]) - 1
