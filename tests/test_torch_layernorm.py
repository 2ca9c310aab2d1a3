"""K8, NAFNet's channels-last LayerNorm (moephoto_tpu_torch/ops/layernorm.py,
csrc/layernorm.cu): the plain versions of both modes on the CPU, the
wrapper's checks, NAFBlock's fused call, and on the card the kernel
against the plain versions and under CUDA-graph capture.

Tolerances.  Two norms that sum in another order: fp32 within 2e-6 *
max(1, |ref|) for the plain version against ``F.layer_norm`` (what
``LayerNorm2d`` called before K8) on the CPU, 1e-5 * max(1, |plain|) for
the kernel against the plain version on the card; bf16 within one bf16 ulp
of max(|ref|, 2^-8), since a value near a rounding boundary may round the
other way (below 2^-8 the output cancels, and the two fp32 values before
rounding differ by a few fp32 ulps of the terms, ~1e-6, more than an ulp
of the result).  Mode (b)'s ``z`` is formed by the same rounded fp32
operations on both sides: bit-equal.
"""

import pytest
import torch
import torch.nn.functional as F

from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import nafnet
from moephoto_tpu_torch.ops import layernorm as LN
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

EPS = 1e-5
WIDTHS = (32, 64, 512, 1024)
CARD_WIDTHS = (32, 64, 128, 256, 512, 1024)
ULP_FLOOR = 2.0**-8


def _features(seed, shape, dtype=torch.float32, device="cpu", mean=3.0):
    """(N, C, H, W) NCHW view of channels-last values around ``mean`` (a
    large mean is where a one-pass variance loses digits)."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    v = mean + torch.randn((n, h, w, c), generator=g)
    return v.to(device, dtype).permute(0, 3, 1, 2)


def _params(seed, c, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [t.to(device, dtype) for t in (1 + 0.3 * torch.randn(c, generator=g), 0.3 * torch.randn(c, generator=g),
                                          0.2 * torch.randn(c, generator=g), 0.5 * torch.randn(1, c, 1, 1, generator=g))]


def _bf16Ulp(v: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of |v|, at least of ``floor``."""
    a = v.float().abs().clamp_min(max(floor, 2.0**-126))
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _todayLayerNorm(x, weight, bias):
    """``LayerNorm2d.forward`` before K8: F.layer_norm on the channels-last view."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), weight.to(x.dtype), bias.to(x.dtype), EPS)
    return y.permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_norm_matches_f_layer_norm(c, dtype):
    """The plain version of mode (a), and ``LayerNorm2d`` on the CPU, which
    runs it, against F.layer_norm; the result an NCHW view of NHWC memory."""
    x = _features(c, (2, c, 5, 7), dtype)
    weight, bias, _, _ = _params(c + 1, c)
    got = LN.layerNormPlain(x, weight, bias, EPS)
    want = _todayLayerNorm(x, weight, bias)
    assert got.dtype == dtype and got.shape == x.shape and got.permute(0, 2, 3, 1).is_contiguous()
    norm = PA.LayerNorm2d(c).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        assert torch.equal(norm(x), got)
    err = (got.float() - want.float()).abs()
    tol = 2e-6 * want.float().abs().clamp_min(1.0) if dtype == torch.float32 else _bf16Ulp(want, ULP_FLOOR)
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", (32, 512))
def test_plain_residual_rounds_z_once(c, dtype):
    """Mode (b)'s plain ``z`` is ``x + (y + b) * beta`` in fp32 rounded once,
    its ``n`` mode (a) on that ``z``; in bf16 the one rounding is closer to
    the exact sum than the block's three roundings before K8."""
    x, y = _features(c, (2, c, 6, 5), dtype, mean=0.0), _features(c + 1, (2, c, 6, 5), dtype, mean=0.0)
    weight, bias, b, beta = (p.to(dtype) for p in _params(c + 2, c))
    z, n = LN.residualLayerNormPlain(x, y, b, beta, weight, bias, EPS)
    f = lambda t: t.float()
    want = (f(x) + (f(y) + f(b)[:, None, None]) * f(beta)).to(dtype)
    assert torch.equal(z, want) and z.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(n, LN.layerNormPlain(z, weight, bias, EPS))
    got, _ = LN.residualLayerNorm(x, y, b, beta, weight, bias, EPS)
    assert torch.equal(got, z)
    if dtype == torch.bfloat16:
        exact = x.double() + (y.double() + b.double()[:, None, None]) * beta.double()
        thrice = x + (y + b[:, None, None]) * beta
        once, before = (z.double() - exact).abs().mean(), (thrice.double() - exact).abs().mean()
        assert once < before, (float(once), float(before))


def test_nafblock_runs_the_fused_norm(monkeypatch):
    """A NAFBlock calls ``residualLayerNorm`` once, with ``conv3``'s bias,
    ``beta`` and ``norm2``'s parameters, and ``norm2`` itself never; its
    output equals the unfused block (conv3 with its bias, the scaled
    residual, norm2) within fp32 rounding."""
    torch.manual_seed(0)
    block = nafnet.NAFBlock(32)
    with torch.no_grad():
        for p in (block.beta, block.gamma, block.norm2.bias):
            p.copy_(0.5 * torch.randn_like(p))
    x = _features(3, (2, 32, 9, 8))
    calls, norm2 = [], []
    fused = nafnet.residualLayerNorm

    def spy(*args):
        calls.append(args)
        return fused(*args)

    monkeypatch.setattr(nafnet, "residualLayerNorm", spy)
    block.norm2.register_forward_hook(lambda *_: norm2.append(1))
    with torch.no_grad():
        got = block(x)
        y1, y2 = block.conv2(block.conv1(block.norm1(x))).chunk(2, 1)
        y = y1 * y2
        z = x + block.conv3(y * block.sca[1](PA.globalAvgPool(y))) * block.beta
        y1, y2 = block.conv4(block.norm2(z)).chunk(2, 1)
        want = z + block.conv5(y1 * y2) * block.gamma
    assert len(calls) == 1 and len(norm2) == 1  # the one norm2 call is the unfused block's
    assert calls[0][2] is block.conv3.bias and calls[0][3] is block.beta and calls[0][4] is block.norm2.weight
    err = (got - want).abs()
    assert bool((err <= 1e-5 * want.abs().clamp_min(1.0)).all()), float(err.max())


def _meta(shape=(1, 32, 4, 4), dtype=torch.float32, channelsLast=True):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.contiguous(memory_format=torch.channels_last) if channelsLast else t


@pytest.mark.parametrize("case,error,match", [
    ("fp16", TypeError, "fp32 or bf16"),
    ("c24", ValueError, "multiple of 8"),
    ("c36", ValueError, "multiple of 8"),
    ("c1032", ValueError, "multiple of 8"),
    ("nchw", ValueError, "channels-last"),
    ("y_shape", ValueError, "y "),
    ("weight_size", ValueError, "holds 16 values"),
    ("mixed", ValueError, "CUDA device"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, error, match):
    """Off the CPU the wrapper holds the kernel's terms (checked on meta
    tensors, which carry shapes, strides and dtypes): fp32 or bf16, C a
    multiple of 8 in [32, 1024], channels-last features of one shape, C
    values a parameter, everything on one device, a CUDA one or meta."""
    x, w, b = _meta(), torch.ones(32, device="meta"), torch.zeros(32, device="meta")
    y, scale = _meta(), torch.ones(1, 32, 1, 1, device="meta")
    if case == "fp16":
        x = _meta(dtype=torch.float16)
    elif case.startswith("c"):
        c = int(case[1:])
        x, w, b = _meta((1, c, 4, 4)), torch.ones(c, device="meta"), torch.zeros(c, device="meta")
    elif case == "nchw":
        x = _meta(channelsLast=False)
    elif case == "weight_size":
        w = torch.ones(16, device="meta")
    elif case == "mixed":
        x = torch.zeros(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
    if case == "y_shape":
        with pytest.raises(error, match=match):
            LN.residualLayerNorm(x, _meta((1, 32, 4, 8)), b, scale, w, b, EPS)
        return
    with pytest.raises(error, match=match):
        LN.layerNorm(x, w, b, EPS)
    with pytest.raises(error, match=match):
        LN.residualLayerNorm(x, x if case in ("fp16", "nchw") or case.startswith("c") else y, b,
                             torch.ones(x.shape[1], device="meta"), w, b, EPS)


def test_meta_tensors_get_the_plain_shapes():
    """Shape-only runs (an operation count on the meta device, as
    ``chip_smoke.tileMacs`` makes) get both modes' outputs as NCHW views of
    NHWC tensors, and a whole NAFNet runs on meta."""
    x, y = _meta((2, 64, 5, 3)), _meta((2, 64, 5, 3))
    w, b, scale = torch.ones(64, device="meta"), torch.zeros(64, device="meta"), torch.ones(1, 64, 1, 1, device="meta")
    n = LN.layerNorm(x, w, b, EPS)
    z, n2 = LN.residualLayerNorm(x, y, b, scale, w, b, EPS)
    for t in (n, z, n2):
        assert t.is_meta and t.shape == x.shape and t.dtype == x.dtype and t.permute(0, 2, 3, 1).is_contiguous()
    with torch.device("meta"), torch.no_grad():  # a count takes no gradient: K8 has no backward
        model = nafnet.NAFNet(32, 1, (1,), (1,))
        out = model(torch.empty(1, 32, 32, 3))
    assert out.is_meta and out.shape == (1, 32, 32, 3)


@pytest.mark.parametrize("graded", ["x", "y", "weight", "bias", "yBias", "scale"])
def test_kernel_refuses_what_autograd_would_differentiate(graded):
    """K8 has no backward: off the CPU, with gradients on, an input or
    parameter that requires one makes both modes raise rather than return
    a result cut off from the graph; under ``no_grad`` the same call runs."""
    t = {"x": _meta(), "y": _meta(), "weight": torch.ones(32, device="meta"), "bias": torch.zeros(32, device="meta"),
         "yBias": torch.zeros(32, device="meta"), "scale": torch.ones(1, 32, 1, 1, device="meta")}
    t[graded].requires_grad_()
    residual = lambda: LN.residualLayerNorm(t["x"], t["y"], t["yBias"], t["scale"], t["weight"], t["bias"], EPS)
    calls = [residual] if graded in ("y", "yBias", "scale") else \
        [residual, lambda: LN.layerNorm(t["x"], t["weight"], t["bias"], EPS)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def _tinyNAFNet(seed=0):
    """A NAFNet of width 32 with one block a level and one in the middle,
    on synth draws (beta and gamma nonzero, so every branch has a gradient)."""
    from moephoto_tpu_torch.synth import synthNAFNetParams

    model = nafnet.NAFNet(32, 1, (1,), (1,))
    model.load_state_dict(synthNAFNetParams(32, 1, (1,), (1,), seed=seed), strict=True)
    return model


def test_fused_switch_reaches_every_block_and_norm():
    """``NAFNet.fused`` sets every block's and norm's switch, as
    ``tools/train.buildModel`` sets it for training; with it on, a forward
    pass that autograd records raises at the first norm (on meta tensors,
    held to the kernel's terms), with it off the pass runs."""
    model = _tinyNAFNet().to("meta")
    parts = [m for m in model.modules() if isinstance(m, (nafnet.NAFBlock, PA.LayerNorm2d))]
    assert len(parts) == 3 * 3 and model.fused and all(m.fused for m in parts)
    x = torch.empty(1, 16, 16, 3, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)
    model.fused = False
    assert not model.fused and not any(m.fused for m in parts)
    assert model(x).shape == (1, 16, 16, 3)
    model.fused = True
    assert model.fused and all(m.fused for m in parts)


def test_train_build_model_turns_nafnet_to_the_plain_path(monkeypatch, tmp_path):
    """``tools/train.buildModel`` on a NAFNet registry entry returns the
    model with ``fused`` off (the checkpoint's load stubbed out)."""
    from moephoto_tpu_torch.models import api
    from moephoto_tpu_torch.pipeline import registry as R
    from moephoto_tpu_torch.tools import train as T

    ckpt = tmp_path / "nafnet.pth"
    ckpt.write_bytes(b"")
    monkeypatch.setattr(R, "modelPath", lambda _: str(ckpt))
    monkeypatch.setattr(api, "loadTorchWeights", lambda *_: {})
    model = T.buildModel("NAFNet_32", 1)[0]
    assert isinstance(model, nafnet.NAFNet) and not model.fused
    assert not any(m.fused for m in model.modules() if isinstance(m, (nafnet.NAFBlock, PA.LayerNorm2d)))


def _blockBeforeK8(self, f):
    """``NAFBlock.forward`` before K8: conv3 with its bias, the scaled
    residual, then norm2."""
    y1, y2 = self.conv2(self.conv1(self.norm1(f))).chunk(2, 1)
    t = y1 * y2
    z = f + self.conv3(t * self.sca[1](PA.globalAvgPool(t))) * self.beta.to(f.dtype)
    y1, y2 = self.conv4(self.norm2(z)).chunk(2, 1)
    return z + self.conv5(y1 * y2) * self.gamma.to(f.dtype)


def _trainGrads(model, device, before=False, monkeypatch=None):
    """The gradients of the fine-tuning CLI's loss (``makeShardedLoss`` on a
    [1, 1] mesh, in fp32) for a seeded batch, by parameter name."""
    import numpy as np

    from moephoto_tpu_torch.parallel import sharded as S
    from moephoto_tpu_torch.parallel.mesh import makeMesh

    if before:
        monkeypatch.setattr(nafnet.NAFBlock, "forward", _blockBeforeK8)
        monkeypatch.setattr(PA.LayerNorm2d, "forward", lambda self, f: _todayLayerNorm(f, self.weight, self.bias))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)).to(device)
    masters = {k: p.detach().to(device).requires_grad_() for k, p in model.state_dict().items()}
    lossOf = S.makeShardedLoss(model.to(device), makeMesh([1, 1], devices=[device]), 8, 1)
    with PA.fullFp32():
        grads = torch.autograd.grad(lossOf(masters, x, y), list(masters.values()))
    return {k: g.cpu() for k, g in zip(masters, grads)}


def _assertGradsMatch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        scale = float(want[k].abs().max())
        assert scale > 0, f"{k} has no gradient"
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_train_step_gradients_match_the_block_before_k8(monkeypatch):
    """A train step through NAFNet with ``fused`` off reaches every
    parameter, and its gradients equal those of the block as it ran before
    K8 (conv3's bias, the scaled residual and F.layer_norm apart) within
    fp32 rounding."""
    model = _tinyNAFNet(3)
    model.fused = False
    got = _trainGrads(model, "cpu")
    _assertGradsMatch(got, _trainGrads(model, "cpu", before=True, monkeypatch=monkeypatch))


# --- on the card -----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assertNear(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        tol = 1e-5 * want.float().abs().clamp_min(1.0)
    else:
        tol = _bf16Ulp(want, ULP_FLOOR)
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_matches_plain_on_card(dtype):
    """K8 in both modes against the plain versions at C = 32-1024 on row
    counts that fill no whole pass of a block (7 x 13 x 2, and a 129 x 67
    image), outputs in NHWC; mode (b)'s ``z`` bit-equal; one launch a call."""
    dev = _card()
    for c in CARD_WIDTHS:
        for shape in ((2, c, 7, 13), (1, c, 129, 67)):
            x, y = _features(c, shape, dtype, dev), _features(c + 7, shape, dtype, dev, mean=0.0)
            weight, bias, b, beta = _params(c + 1, c, dtype, dev)
            before = LN.layerNorm.launches
            n = LN.layerNorm(x, weight, bias, EPS)
            z, n2 = LN.residualLayerNorm(x, y, b, beta, weight, bias, EPS)
            torch.cuda.synchronize()
            assert LN.layerNorm.launches == before + 2
            assert n.permute(0, 2, 3, 1).is_contiguous() and z.permute(0, 2, 3, 1).is_contiguous()
            _assertNear(n, LN.layerNormPlain(x, weight, bias, EPS))
            zp, np2 = LN.residualLayerNormPlain(x, y, b, beta, weight, bias, EPS)
            assert torch.equal(z, zp), (c, shape)
            _assertNear(n2, np2)
            assert torch.equal(n2, LN.layerNorm(z, weight, bias, EPS))  # (b)'s n is (a) on the z it wrote


@pytest.mark.cuda
def test_train_step_on_card_matches_the_cpu():
    """On the card a recorded forward pass through the fused model raises
    (K8 has no backward); with ``fused`` off the train step's gradients
    reach every parameter and equal the CPU's within fp32 rounding."""
    dev = _card()
    model = _tinyNAFNet(5)
    with pytest.raises(RuntimeError, match="no backward"):
        _trainGrads(model, dev)
    model.fused = False
    _assertGradsMatch(_trainGrads(model, dev), _trainGrads(model, "cpu"))


@pytest.mark.cuda
def test_kernel_raises_on_an_unaligned_tensor():
    dev = _card()
    flat = torch.zeros(1 + 4 * 4 * 32, device=dev)
    x = flat[1:].view(1, 4, 4, 32).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        LN.layerNorm(x, torch.ones(32, device=dev), torch.zeros(32, device=dev), EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_graph_capture_replays_the_eager_result(dtype):
    """Both modes captured in one CUDA graph replay bit-equal to eager
    launches, on new inputs written into the captured ones."""
    dev = _card()
    x, y = _features(1, (3, 64, 33, 20), dtype, dev), _features(2, (3, 64, 33, 20), dtype, dev, mean=0.0)
    weight, bias, b, beta = _params(3, 64, dtype, dev)
    run = lambda: (LN.layerNorm(x, weight, bias, EPS),) + LN.residualLayerNorm(x, y, b, beta, weight, bias, EPS)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = run()
    x.copy_(_features(4, x.shape, dtype, dev))
    y.copy_(_features(5, y.shape, dtype, dev, mean=0.0))
    g.replay()
    want = run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(outs, want))
