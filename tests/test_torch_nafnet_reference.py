"""The port's NAFNet (``moephoto_tpu_torch/models/nafnet.py``) and the DN
step's chain around it (``registry.getDN`` -> ``ModelExec`` -> the tiler)
against the benchmark's plain reference (``benchmark/reference/nafnet.py``)
on the CPU in fp32, with weights drawn by the benchmark cell's own rule
(``benchmark/configs/nafnet_sidd32.json``) at width 32: one block a level
and 2 middle blocks, and once the whole SIDD-32 stack on one 64 x 64 tile;
three planted faults that the comparison must catch; the reference's
departures from the published NAFNet; the three ``moe.nafnet.*`` spans.

Tolerances, both sides fp32 and computing the same operations in sums of
another order (``F.layer_norm`` against a written-out mean and variance,
cuDNN-free CPU convolutions with other blockings): 1e-4 absolute on
outputs in [0, 1] and on the tiled image, since ~40 layers of fp32
rounding (1e-7 relative each) on features of magnitude up to ~30 stay
two orders below it, while each planted fault moves outputs by 1e-2 or
more; the 8-bit outputs within 1 step, since the output step truncates
and a value at a step's edge moves one step for a difference of 1e-7.
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
from benchmark.reference import lite
from benchmark.reference import nafnet as R
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.executor import ModelExec, weightsKey
from moephoto_tpu_torch.engine.tiling import TileSpec
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import nafnet as P
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = (32, 2, (1, 1, 1, 1), (1, 1, 1, 1))  # width, middle blocks, encoder and decoder counts
SIDD32 = (32, 12, (2, 2, 4, 8), (2, 2, 2, 2))
SPEC = {"tile": 64, "pad": 8, "align": 16, "scale": 1, "batch": 3}
H, W, SEED = 80, 112, 2**31 + 22
TOL, LSB_MAX = 1e-4, 1


def _rule():
    with open(os.path.join(ROOT, "benchmark", "configs", "nafnet_sidd32.json")) as fp:
        return json.load(fp)["weights"]


def _pair(sizes, seed):
    """(reference, port) with one set of weights drawn by the cell's rule."""
    ref = R.NAFNet(*sizes)
    sd = R.drawWeights(ref, _rule(), seed, "cpu", torch.float32)
    ref.load_state_dict(sd, strict=True)
    port = P.NAFNet(*sizes)
    port.load_state_dict(sd, strict=True)
    return ref.eval(), port.eval(), sd


@pytest.fixture(scope="module")
def models():
    return _pair(SHORT, SEED)


@pytest.fixture(scope="module")
def image():
    """An 80 x 112 uint8 photo: 2 x 2 tiles of 64 at pad 8, the height
    reflect-padded to 112, a chunk of 3 tiles and a padded chunk of 1."""
    x = picture(torch.Generator().manual_seed(SEED), H, W, "cpu")
    return (x * 255).round().to(torch.uint8).permute(1, 2, 0).contiguous().numpy()


def _port(model):
    return lambda x: model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol, err


@pytest.fixture
def dnStep(tmp_path, monkeypatch):
    """``registry.getDN`` for ``NAFNet_32`` at the short stack and the small
    tile spec, on the CPU in fp32, its checkpoint under a fresh model
    directory: a function of the weights to the step's ``ModelExec``."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "modelDir", str(tmp_path))
    monkeypatch.setattr(P, "nafNetSIDD32", functools.partial(P.NAFNet, *SHORT))
    entry = dict(registry.DN_REGISTRY["NAFNet_32"], spec=TileSpec(SPEC["tile"], SPEC["pad"], SPEC["align"], 1.0,
                                                                  SPEC["batch"]))
    monkeypatch.setitem(registry.DN_REGISTRY, "NAFNet_32", entry)

    def make(sd):
        registry._modelCache.clear()
        registry._paramsCache.clear()
        path = tmp_path / "NAFNet" / "NAFNet-SIDD-width32.pth"
        path.parent.mkdir(exist_ok=True)
        torch.save(sd, path)
        ex = registry.getDN({"model": "NAFNet_32"})
        assert ex.dtype == torch.float32 and not ex.channelSplit
        return ex

    yield make
    registry._modelCache.clear()
    registry._paramsCache.clear()


def _chain(ex, image):
    """The DN step's float result and the 8-bit output the chain writes."""
    x = torch.from_numpy(image).float() / 255.0
    y = ex(x)
    return y, lite.toOutput8(y)


def _want(ref, image):
    x = torch.from_numpy(image).permute(2, 0, 1).float() / 255.0
    with torch.no_grad():
        y = R.tiledRGB(x, ref, SPEC["tile"], SPEC["pad"], SPEC["align"], SPEC["batch"]).permute(1, 2, 0)
    return y, R.dnImage(ref, image, SPEC, "cpu")


def test_blocks_match_the_port(models):
    """One NAFBlock at 64 channels and the short U-Net on two tiles."""
    ref, port, _ = models
    x = torch.rand(2, 3, 64, 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        b = ref.layers[1].encoder[0]
        f = torch.randn(2, 64, 16, 12, generator=torch.Generator().manual_seed(2))
        _close(port.layers[1].encoder[0](f), b(f), 1e-4 * float(b(f).abs().max()))
        _close(_port(port)(x), ref(x))
        assert float((ref(x) - x).square().mean().sqrt()) > 0.05  # the blocks add a residual


def test_full_depth_matches_the_port():
    """The whole SIDD-32 stack (36 blocks, widths 32-512) on one 64 x 64
    tile: 4 x 4 at the middle's 512 channels."""
    ref, port, _ = _pair(SIDD32, SEED + 1)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _close(_port(port)(x), ref(x))


def test_dn_step_matches_dn_image(models, image, dnStep):
    """The DN step's ``ModelExec`` on 80 x 112: four tiles, a padded last
    chunk, the reflect pad, the blend; against the reference's tiler and
    ``dnImage``."""
    ref, _, sd = models
    got, got8 = _chain(dnStep(sd), image)
    want, want8 = _want(ref, image)
    _close(got, want)
    d = got8.float() - want8.float()
    assert float(d.abs().max()) <= LSB_MAX and float(d.square().mean().sqrt()) < 0.1


def _fails(got, want):
    return float((got - want).abs().max()) > TOL


def test_zeroed_beta_fails(models, image, dnStep):
    ref, _, sd = models
    bad = {k: (torch.zeros_like(v) if k.endswith(".beta") else v) for k, v in sd.items()}
    assert _fails(_chain(dnStep(bad), image)[0], _want(ref, image)[0])


def test_unbiased_norm_fails(models, image, dnStep, monkeypatch):
    ref, _, sd = models

    def unbiased(self, x):
        mu = x.mean(1, keepdim=True)
        var = x.var(1, keepdim=True, unbiased=True)
        return (x - mu) / (var + self.eps).sqrt() * self.weight[:, None, None] + self.bias[:, None, None]

    monkeypatch.setattr(PA.LayerNorm2d, "forward", unbiased)
    assert _fails(_chain(dnStep(sd), image)[0], _want(ref, image)[0])


def test_whole_image_pooling_fails(models, image, dnStep):
    """The image run whole, as the published model runs it: SCA then pools
    over the whole image, not over each tile."""
    ref, _, sd = models
    x = torch.from_numpy(image).float() / 255.0
    assert _fails(dnStep(sd).applyWhole(x), _want(ref, image)[0])


def test_eps_is_moephotos():
    """LayerNorm2d's eps is 1e-5 on both sides (the published 1e-6 gives
    another result on features whose variance is near eps)."""
    g = torch.Generator().manual_seed(4)
    x = 1.0 + 3e-3 * torch.randn(1, 32, 5, 7, generator=g)
    ref, port = R.LayerNorm2d(32), PA.LayerNorm2d(32)
    assert ref.eps == port.eps == R.EPS == 1e-5
    with torch.no_grad():
        _close(port(x), ref(x), 1e-4)
        ref.eps = 1e-6
        assert float((ref(x) - port(x)).abs().max()) > 1e-2


def test_reflect_pad_not_zero_pad(models):
    """A 40 x 56 image is one tile, reflect-padded to 48 x 64 and cropped;
    the published ``check_image_size`` pads with zeros and gives another
    result."""
    ref, _, _ = models
    x = torch.rand(3, 40, 56, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = R.tiledRGB(x, ref, SPEC["tile"], SPEC["pad"], SPEC["align"])
        refl = ref(F.pad(x[None], (0, 8, 0, 8), mode="reflect"))[0, :, :40, :56]
        zero = ref(F.pad(x[None], (0, 8, 0, 8)))[0, :, :40, :56]
    _close(got, refl, 1e-6)
    assert float((zero - refl).abs().max()) > 1e-2


def test_spans_once_a_model_call(models, image, dnStep):
    """The CPU profiler records ``moe.nafnet.encoder``, ``.middle`` and
    ``.decoder`` once each a model call (two chunks), nested in order in
    ``moe.engine.chunk``; the benchmark's ``nafnet_host_ms.dn`` reads them."""
    _, _, sd = models
    ex = dnStep(sd)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            _chain(ex, image)
    tr = tracing.fromProfiler(prof)
    spans = sorted((s, n) for n, s, _ in tr.host if n.startswith("moe.nafnet.") or n == "moe.engine.chunk")
    stages = ["moe.nafnet.encoder", "moe.nafnet.middle", "moe.nafnet.decoder"]
    assert [n for _, n in spans] == (["moe.engine.chunk"] + stages) * 2
    run = Run(0.0, Window(*tr.window, items=[Item(0.0, 1.0)]), tr)
    ms = spec.cell("dn_nafnet32_1080p").reader("nafnet_host_ms.dn").read(run)
    assert 0 < ms <= 1e3 * tr.window_s


def test_spans_cost_nothing_when_off(models):
    """Without a profiler the model records no range: a span is the shared
    no-op context."""
    from moephoto_tpu_torch import progress

    assert not torch.autograd._profiler_enabled()
    assert progress.span("moe.nafnet.encoder") is progress.span("moe.nafnet.middle")


def test_a_copy_or_a_move_drops_the_stage_graphs(models, monkeypatch):
    """A capture reads the weights at the addresses it was captured with,
    under the TF32 settings of that moment: ``ModelExec`` keys it on both,
    so a move or cast of the model (``.to``), a parameter replaced, or a
    TF32 switch (``models.api.fullFp32``) captures anew.  The model holds
    no graph: a copy (a mesh replica) or a ``functional_call`` with other
    tensors runs its own weights; on the CPU the exec captures nothing."""
    import copy

    ref, _, sd = models
    port = P.NAFNet(*SHORT)
    port.load_state_dict(sd)
    ex = ModelExec(port, TileSpec(64, 8, 16, 1.0, 3), dtype=torch.float32, device="cpu")
    t = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    key = weightsKey(ex.model)
    assert weightsKey(ex.model) == key
    with PA.fullFp32():
        assert weightsKey(ex.model) != key
    assert weightsKey(ex.model) == key
    monkeypatch.undo()
    key = weightsKey(ex.model)
    ex.model = copy.deepcopy(port)
    assert weightsKey(ex.model) != key
    ex.model = port
    port.intro.weight = torch.nn.Parameter(port.intro.weight.detach().clone())
    assert weightsKey(ex.model) != key
    key = weightsKey(ex.model)
    port.to(torch.float64)
    assert weightsKey(ex.model) != key
    port.to(torch.float32)
    assert not any("graph" in k.lower() for k in vars(port))
    with torch.inference_mode():
        ex._run(port, t)
    assert ex._graphs is None
    zeroed = {k: (torch.zeros_like(v) if k.endswith(".beta") else v) for k, v in sd.items()}
    with torch.no_grad():
        got = torch.func.functional_call(port, zeroed, (t,))
        ref.load_state_dict(zeroed)
        want = ref(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ref.load_state_dict(sd)
        assert float((got - port(t)).abs().max()) > 1e-2
    _close(got, want)


GOPRO64 = (64, 1, (1, 1, 1, 28), (1, 1, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,dtype", [(SHORT, torch.float32), (SHORT, torch.bfloat16), (SIDD32, torch.bfloat16),
                                         (GOPRO64, torch.bfloat16)], ids=["short-fp32", "short-bf16", "sidd32-bf16",
                                                                          "gopro64-bf16"])
def test_stage_graphs_match_eager_on_the_card(sizes, dtype):
    """On the card ``ModelExec`` replays a full chunk's stages as CUDA
    graphs: bit-equal to the same exec run eagerly (the model behind a
    function without stages), at the short stack and the whole SIDD-32 and
    GoPro-64 depths; one capture for two images; a replaced parameter
    captures anew, with the new weights' result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, port, _ = _pair(sizes, SEED)
    port = port.to("cuda", dtype).to(memory_format=torch.channels_last)
    spec = TileSpec(64, 8, 16, 1.0, 3)
    ex = ModelExec(port, spec, dtype=dtype, device="cuda")
    eager = ModelExec(lambda t: port(t), spec, dtype=dtype, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    a, b = (torch.rand(112, 160, 3, generator=g, device="cuda") for _ in range(2))
    ga, gb = ex(a), ex(b)
    graphs = ex._graphs
    assert graphs is not None and [n for n, _ in graphs.graphs] == [n for n, _ in port.stages()]
    ea, eb = eager(a), eager(b)
    assert ex._graphs is graphs
    assert torch.equal(ga, ea) and torch.equal(gb, eb) and not torch.equal(ga, gb)
    with torch.no_grad():
        port.ending.weight = torch.nn.Parameter(port.ending.weight * 2)
    ga = ex(a)
    assert ex._graphs is not graphs and torch.equal(ga, eager(a)) and not torch.equal(ga, ea)
