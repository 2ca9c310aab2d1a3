"""The port's row-sharded kernel wrappers and stages against its own
single-device ones (exactly) and the JAX package's ``shard_map`` forms on its
8 virtual CPU devices (JAX's tolerances): K2a (``warpSpmd``,
``backWarpSpmd``), K3's tier (``deformConv2d`` under ``spmdTracing()``), K6
(``ailutTransformSpmd``), IFRNet's row-sharded ``encodeFull`` and
``decodePost``, and ``cli video`` slomo on a mesh.  The JAX Pallas forms run
in interpret mode (``MOEPHOTO_SPMD_PALLAS=interpret``), as
``tests/test_parallel.py`` runs them.  On the CPU every shard takes the
kernels' plain versions; the ``cuda`` tests hold the kernels themselves."""

import contextlib
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.parallel import mesh as jaxMesh
from moephoto_tpu.parallel import temporal as jaxTemporal
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.ops import deform as D
from moephoto_tpu_torch.ops import lut as L
from moephoto_tpu_torch.ops import warp as W
from moephoto_tpu_torch.parallel import mesh as M
from moephoto_tpu_torch.parallel import sharded as S
from moephoto_tpu_torch.parallel import temporal as T
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


@contextlib.contextmanager
def jaxCpuMesh(shape, monkeypatch=None):
    """The JAX package's [8] mesh on its virtual CPU devices, with its SPMD
    Pallas wrappers in interpret mode; config and caches restored after."""
    old = (jaxConfig.meshShape, getattr(jaxConfig, "meshBackend", ""))
    jaxConfig.meshShape, jaxConfig.meshBackend = list(shape), "cpu"
    jaxMesh._activeMesh[:] = [None, None]
    jaxTemporal._videoMesh[:] = [None, None]
    try:
        assert jaxTemporal.videoMesh() is not None
        if monkeypatch is not None:
            monkeypatch.setenv("MOEPHOTO_SPMD_PALLAS", "interpret")
        yield
    finally:
        jaxConfig.meshShape, jaxConfig.meshBackend = old
        jaxMesh._activeMesh[:] = [None, None]
        jaxTemporal._videoMesh[:] = [None, None]


@pytest.fixture(autouse=True)
def cpuDevice(monkeypatch):
    """The port's mesh lies on ``config.device``'s platform: the CPU here;
    the card tests pass their tensors' device themselves."""
    monkeypatch.setattr(config, "device", "cpu")


@pytest.fixture
def cpuMesh():
    """The port's mesh of 8 CPU entries, installed, and cleared after."""
    M.installMesh(M.makeMesh([8], devices=CPU8))
    S.resetStats()
    yield M.activeMesh()
    M.installMesh(None)


def _shards(x, align=1, devices=CPU8):
    return S.RowShards.split(torch.from_numpy(x) if isinstance(x, np.ndarray) else x, devices, 1, align)


def _equal(got, ref):
    """Bit-equal, NaN where the reference is NaN."""
    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))


# --- K2a ----------------------------------------------------------------------

WARP_CASES = {  # (shape, flow scale): 8 shards of the rows
    "fits_one_neighbour": ((2, 64, 40, 3), 6.5),   # reach 8 = the shard height
    "spans_shards": ((1, 64, 40, 3), 20.0),        # reach up to 21 rows: three shards away
    "shorter_than_halo": ((2, 16, 40, 3), 6.0),    # 2 rows a shard, reach 7
}


def _warpCase(name, seed=5, dtype=np.float32):
    shape, scale = WARP_CASES[name]
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape).astype(dtype)
    flow = ((rng.rand(*shape[:3], 2) * 2 - 1) * scale).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("name", list(WARP_CASES))
def test_warp_spmd_equals_single_device(name, mode):
    """Every row of every shard bit-equal to the single-device warp, fp32
    and bf16 images, any reach; one host read a call."""
    img, flow = _warpCase(name)
    for x in (torch.from_numpy(img), torch.from_numpy(img).to(torch.bfloat16)):
        S.resetStats()
        got = W.warpSpmd(_shards(x), _shards(flow), mode)
        assert S.stats["hostReads"] == 1 and got.bounds == _shards(flow).bounds
        _equal(got.gather(), W.warp(x, torch.from_numpy(flow), mode))


@pytest.mark.parametrize("name,mode", [("fits_one_neighbour", "border"), ("fits_one_neighbour", "zeros"),
                                       ("spans_shards", "border"), ("shorter_than_halo", "border")])
def test_warp_spmd_matches_jax(name, mode, monkeypatch):
    """Against JAX's ``warpBoundedSpmd`` on its [8] mesh (interpret mode;
    its tiers and XLA fallback), atol 2e-5 as ``tests/test_parallel.py``."""
    import jax.numpy as jnp

    from moephoto_tpu.ops import warp as jaxWarp

    img, flow = _warpCase(name)
    with jaxCpuMesh([8], monkeypatch):
        ref = np.asarray(jaxWarp.warpBoundedSpmd(jnp.asarray(img), jnp.asarray(flow), mode, interpret=True))
    got = W.warpSpmd(_shards(img), _shards(flow), mode).gather().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_warp_spmd_nan_and_huge_flows(monkeypatch):
    """NaN and infinite flows do not size the halo (the largest finite
    reach does, here 1e6: every shard's window is the whole image); the
    result is NaN exactly where the single-device warp's is, equal
    elsewhere, and matches JAX's ``warpBoundedSpmd`` outside the NaNs."""
    import jax.numpy as jnp

    from moephoto_tpu.ops import warp as jaxWarp

    img, flow = _warpCase("fits_one_neighbour", 9)
    flow[0, 3, 5] = (np.nan, np.nan)
    flow[1, 40, 2, 1] = np.inf
    flow[1, 20, 7] = (0.0, 1e6)
    for mode in ("border", "zeros"):
        _equal(W.warpSpmd(_shards(img), _shards(flow), mode).gather(), W.warp(torch.from_numpy(img),
                                                                               torch.from_numpy(flow), mode))
    finite = flow.copy()
    finite[0, 3, 5] = finite[1, 40, 2] = 0.0  # JAX's tier picks from max |flow|, which NaN would poison
    with jaxCpuMesh([8], monkeypatch):
        ref = np.asarray(jaxWarp.warpBoundedSpmd(jnp.asarray(img), jnp.asarray(finite), "border", interpret=True))
    got = W.warpSpmd(_shards(img), _shards(finite), "border").gather().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_back_warp_spmd_equals_single_and_jax(monkeypatch):
    """``backWarpSpmd`` folds the normalisation quirk on global rows: bit-equal
    to ``backWarp``, and within 3e-5 of JAX's ``backWarpBoundedSpmd``."""
    import jax.numpy as jnp

    from moephoto_tpu.ops import warp as jaxWarp

    rng = np.random.RandomState(6)
    img = rng.rand(2, 64, 40, 3).astype(np.float32)
    flow = ((rng.rand(2, 64, 40, 2) - 0.5) * 8).astype(np.float32)
    got = W.backWarpSpmd(_shards(img), _shards(flow), "border").gather()
    _equal(got, W.backWarp(torch.from_numpy(img), torch.from_numpy(flow), "border"))
    with jaxCpuMesh([8], monkeypatch):
        ref = np.asarray(jaxWarp.backWarpBoundedSpmd(jnp.asarray(img), jnp.asarray(flow), "border", interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=0)


# --- K3's tier ----------------------------------------------------------------

B_, H_, W_, CIN, COUT, DG = 2, 64, 12, 16, 8, 4


def _dcnCase(scale, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(B_, H_, W_, CIN).astype(np.float32)
    off = ((rng.rand(B_, H_, W_, DG, 9, 2) - 0.5) * scale).astype(np.float32)
    m = rng.rand(B_, H_, W_, DG, 9).astype(np.float32)
    wgt = (rng.rand(3, 3, CIN, COUT) * 0.1).astype(np.float32)  # HWIO, the JAX layout
    bias = rng.rand(COUT).astype(np.float32)
    return x, off, m, wgt, bias


def _portDcn(x, off, m, wgt, bias):
    t = torch.from_numpy
    return D.deformConv2d(t(x), t(off.reshape(B_, H_, W_, -1)), t(m.reshape(B_, H_, W_, -1)),
                          t(wgt).permute(3, 2, 0, 1).contiguous(), t(bias), DG)


def test_dcn_tier_equals_single_device_and_jax(cpuMesh, monkeypatch):
    """``deformConv2d`` under ``spmdTracing()`` on the [8] mesh: bit-equal to
    the single-device call, and within 2e-5 of JAX's tier (the shard_map'd
    Pallas sampler, interpret mode) and of its ``_deformConvGather``, at the
    shapes of ``tests/test_parallel.py``."""
    import jax.numpy as jnp

    from moephoto_tpu.ops.deform import _deformConvGather, deformConv2d as jaxDcn

    case = _dcnCase(5.8)
    T._spmdTracing[0] = True
    try:
        got = _portDcn(*case)
    finally:
        T._spmdTracing[0] = False
    assert S.stats["hostReads"] == 1
    M.installMesh(None)
    _equal(got, _portDcn(*case))
    x, off, m, wgt, bias = (jnp.asarray(a) for a in case)
    gather = np.asarray(_deformConvGather(x, off, m, wgt, bias, DG, 1, 1))
    with jaxCpuMesh([8], monkeypatch):
        jaxTemporal._spmdTracing[0] = True
        try:
            tier = np.asarray(jaxDcn(x, off.reshape(B_, H_, W_, -1), m.reshape(B_, H_, W_, -1), wgt, bias, DG))
        finally:
            jaxTemporal._spmdTracing[0] = False
    np.testing.assert_allclose(got.numpy(), tier, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), gather, atol=2e-5, rtol=0)


@pytest.mark.parametrize("scale", [40.0, 1e6], ids=["spans_shards", "huge_and_nan"])
def test_dcn_tier_far_offsets_equal_single_device(scale):
    """Offsets that reach several shards away (and 1e6, NaN, inf, which the
    reach ignores but for the largest finite one): bit-equal, NaN where the
    single-device call gives NaN."""
    x, off, m, wgt, bias = _dcnCase(scale, 7)
    if scale > 100:
        off[0, 9, 3, 1, 4] = (np.nan, 0.0)
        off[1, 30, 6, 2, 0, 0] = np.inf
    t = torch.from_numpy
    sh = lambda a: _shards(t(a.reshape(B_, H_, W_, -1)))
    got = D.deformConv2dSpmd(sh(x), sh(off), sh(m), t(wgt).permute(3, 2, 0, 1).contiguous(), t(bias), DG)
    _equal(got.gather(), _portDcn(x, off, m, wgt, bias))


# --- K6 -----------------------------------------------------------------------


def _lutCase(D=9, seed=0):
    rng = np.random.RandomState(seed)
    img = (rng.rand(1, 16, 24, 3) * 1.4 - 0.2).astype(np.float32)  # in and out of the vertex range
    lut = rng.rand(1, 3, D, D, D).astype(np.float32)
    iv = rng.rand(1, 3, D - 1).astype(np.float32)
    vert = np.pad(np.cumsum(iv / iv.sum(-1, keepdims=True), -1), ((0, 0), (0, 0), (1, 0))).astype(np.float32)
    return img, lut, vert


def test_ailut_spmd_equals_single_device_and_jax(monkeypatch):
    """Pointwise, so no halo: bit-equal to ``ailutTransform`` in and out of
    the vertex range, and within JAX's own 1e-2 (its kernel contracts in
    bf16 on the matrix unit) of ``ailutTransformPallasSpmd``."""
    import jax.numpy as jnp

    from moephoto_tpu.ops.lutkernel import ailutTransformPallasSpmd

    img, lut, vert = _lutCase()
    t = torch.from_numpy
    assert (img < 0).any() and (img > 1).any()
    got = L.ailutTransformSpmd(_shards(img), t(lut), t(vert)).gather()
    _equal(got, L.ailutTransform(t(img), t(lut), t(vert)))
    with jaxCpuMesh([8], monkeypatch):
        ref = np.asarray(ailutTransformPallasSpmd(jnp.asarray(img), jnp.asarray(lut), jnp.asarray(vert),
                                                  interpret=True))
    assert np.abs(got.numpy() - ref).max() < 1e-2


def test_ailut_model_takes_k6_inside_a_sharded_stage(cpuMesh, monkeypatch):
    """AiLUT's forward under ``spmdTracing()`` transforms through
    ``ailutTransformSpmd`` (``moephoto_tpu/models/ailut.py:121-154``), with
    the single-device result."""
    from moephoto_tpu_torch.models import ailut
    from moephoto_tpu_torch.synth import synthAiLUTParams

    model = ailut.ailutTPAMI()
    model.load_state_dict(synthAiLUTParams("tpami", 3, 0))
    model.eval()
    img = torch.from_numpy(np.random.RandomState(2).rand(1, 32, 24, 3).astype(np.float32))
    calls = []
    spmd = ailut.ailutTransformSpmd
    monkeypatch.setattr(ailut, "ailutTransformSpmd", lambda *a: calls.append(1) or spmd(*a))
    with torch.inference_mode():
        ref = model(img)
        T._spmdTracing[0] = True
        try:
            got = model(img)
        finally:
            T._spmdTracing[0] = False
    assert calls == [1]
    _equal(got, ref)


# --- no fallback --------------------------------------------------------------


def test_sharded_ops_raise_on_mixed_or_foreign_devices():
    """Shards on mixed devices raise; shards on a device that is neither the
    CPU nor CUDA raise instead of taking a plain version."""
    img, flow = _warpCase("fits_one_neighbour")
    mixed = _shards(flow, devices=CPU8[:7] + [torch.device("meta")])
    with pytest.raises(ValueError, match="shards on"):
        W.warpSpmd(_shards(img), mixed)
    meta = [torch.device("meta")] * 8
    with pytest.raises(ValueError):
        W.warpSpmd(_shards(img, devices=meta), _shards(flow, devices=meta))
    x, off, m, wgt, bias = _dcnCase(5.8)
    t = torch.from_numpy
    sh = lambda a, d=CPU8: _shards(t(a.reshape(B_, H_, W_, -1)), devices=d)
    with pytest.raises(ValueError, match="shards on"):
        D.deformConv2dSpmd(sh(x), sh(off, CPU8[:7] + [torch.device("meta")]), sh(m),
                           t(wgt).permute(3, 2, 0, 1), t(bias), DG)
    lutImg, lut, vert = _lutCase()
    with pytest.raises(ValueError):
        L.ailutTransformSpmd(_shards(lutImg, devices=meta), t(lut), t(vert))


# --- IFRNet row-sharded -------------------------------------------------------


def _ifrnet(gain):
    from moephoto_tpu.models import ifrnet as J
    from moephoto_tpu_torch.models import ifrnet as P
    from moephoto_tpu_torch.models.api import fromJaxParams

    jp = {k: np.asarray(v) * (gain if np.asarray(v).ndim == 4 else 1) for k, v in J.synthParams(0).items()}
    model = P.IFRNet("S")
    model.load_state_dict(fromJaxParams(jp, P.isConvT), strict=True)
    return jp, model.eval()


def _portStages(model, frames):
    """encodeFull, then decodePost on the pairs (0, 1) and (1, 2) at times
    0.25 and 0.5, as ``tests/test_parallel.py`` drives the JAX stages."""
    with torch.inference_mode():
        m, inpN, feats = model.encodeFull(torch.from_numpy(frames))
        feats = [f.gather() if isinstance(f, S.RowShards) else f for f in feats]
        f = [torch.stack([torch.stack([lv[0], lv[1]]), torch.stack([lv[1], lv[2]])]) for lv in feats]
        preds = model.decodePost(f, torch.tensor([[0.25], [0.5]]), torch.stack([inpN[0:2], inpN[1:3]]),
                                 torch.stack([m[0:2], m[1:3]]))
    return [m.numpy(), inpN.numpy()] + [lv.numpy() for lv in feats] + [preds.numpy()]


NAMES = ["mean", "norm", "feat0", "feat1", "feat2", "feat3", "preds"]


def test_ifrnet_row_sharded_stages_match_single_and_jax(cpuMesh, monkeypatch):
    """The port's encodeFull and decodePost on the [8] mesh against its
    single-device stages and the JAX package's ``_encodeFullJit`` and
    ``_decodePostJit`` on its [8] mesh: IFRNet-S, 3 frames of 64x64, atol
    2e-5 (mean, frames, features) and 3e-5 (predictions), as
    ``tests/test_parallel.py``.  Every segment whose shards hold its reach
    runs sharded (``GATHER_FROM_LEVEL`` 5: no level gathered by rule), the
    others gathered."""
    import jax.numpy as jnp

    from moephoto_tpu.models import ifrnet as J
    from moephoto_tpu_torch.models import ifrnet as P

    monkeypatch.setattr(P, "GATHER_FROM_LEVEL", 5)
    jp, model = _ifrnet(1.0)
    frames = np.random.RandomState(4).rand(3, 64, 64, 3).astype(np.float32)
    multi = _portStages(model, frames)
    assert S.stats["gathers"] > 0 and S.stats["hostReads"] == 2 * 4  # 8 warps a pair, 2 a read
    M.installMesh(None)
    single = _portStages(model, frames)
    with jaxCpuMesh([8]):
        params = {k: jnp.asarray(v) for k, v in jp.items()}
        chs, side = tuple(J.Channels["S"]), J.SideChannels["S"]
        m, inpN, feats = J._encodeFullJit(chs, jnp.float32)(params, jnp.asarray(frames))
        f = [jnp.stack([jnp.stack([feats[l][0], feats[l][1]]), jnp.stack([feats[l][1], feats[l][2]])])
             for l in range(4)]
        preds = J._decodePostJit(chs, side, 0, jnp.float32)(
            params, f, jnp.asarray([[0.25], [0.5]], jnp.float32), jnp.stack([jnp.asarray(frames[0:2]),
                                                                            jnp.asarray(frames[1:3])]),
            jnp.stack([inpN[0:2], inpN[1:3]]), jnp.stack([m[0:2], m[1:3]]))
        ref = [np.asarray(m), np.asarray(inpN)] + [np.asarray(x) for x in feats] + [np.asarray(preds)]
    for name, a, b, c in zip(NAMES, multi, single, ref):
        tol = 3e-5 if name == "preds" else 2e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(a, c, atol=tol, rtol=1e-5, err_msg=name)


@functools.lru_cache(maxsize=1)
def _reachCase():
    """IFRNet-S with flows of several pixels and features that depend on the
    frames, 3 frames of 256x64, and its single-device stages."""
    _, model = _ifrnet(3.0)
    frames = np.random.RandomState(8).rand(3, 256, 64, 3).astype(np.float32)
    return model, frames, _portStages(model, frames)


@pytest.mark.parametrize("cut", ["product", "none", "encoder", "decoder", "resize"])
def test_ifrnet_segment_reach_is_not_understated(cut, monkeypatch):
    """3 frames of 256x64 over 8 shards of 32 rows, every segment whose
    shards hold its reach sharded (``GATHER_FROM_LEVEL`` 5): the 1/4 and 1/2
    decoder levels (8 and 16 rows a shard) run sharded and the two coarsest,
    whose shards are shorter than the decoder's reach, gathered.  With the
    stated reaches the stages match the single-device ones; with any reach
    one row short the predictions move far beyond the tolerance, so an
    understated reach cannot pass by accident.  ``product``: the shipped
    ``GATHER_FROM_LEVEL`` (3) gathers every segment whose input is at 1/8
    of the rows or coarser as well: the last encoder level, the two
    coarsest decoder levels and the first resize of both flows."""
    from moephoto_tpu_torch.models import ifrnet as P

    model, frames, single = _reachCase()
    if cut != "product":
        monkeypatch.setattr(P, "GATHER_FROM_LEVEL", 5)
    if cut == "encoder":
        halo = P.encoderHalo
        monkeypatch.setattr(P, "encoderHalo", lambda k: halo(k) - 2)  # whole output rows: halos stay even
    elif cut == "decoder":
        monkeypatch.setattr(P, "DEC_HALO", P.DEC_HALO - 1)
    elif cut == "resize":
        monkeypatch.setattr(P, "RESIZE_HALO", P.RESIZE_HALO - 1)
    M.installMesh(M.makeMesh([8], devices=CPU8))
    S.resetStats()
    try:
        multi = _portStages(model, frames)
    finally:
        M.installMesh(None)
    # two decoder levels for each of two pairs; with the shipped rule also the first resize of both
    # flows for each pair, and the last encoder level
    assert S.stats["gathers"] == (2 * 4 + 1 if cut == "product" else 2 * 2) and S.stats["haloBytes"] > 0
    err = np.abs(multi[-1] - single[-1]).max()
    if cut in ("none", "product"):
        for name, a, b in zip(NAMES, multi, single):
            np.testing.assert_allclose(a, b, atol=3e-5 if name == "preds" else 2e-5, rtol=1e-5, err_msg=name)
    else:
        assert err > 1e-4, err


def _clip():
    """6 frames of 48x40 (3 shards of 16 rows): a duplicate (2 = 1) and an
    inverted frame (4), the clip of ``tests/test_torch_ifrnet.py``."""
    rng = np.random.RandomState(1)
    base = [rng.rand(48, 40, 3).astype(np.float32) for _ in range(5)]
    return [base[0], base[1], base[1], base[2], 1 - base[3], base[4]]


def _slomo(model, sf, ensemble, dedupe):
    from moephoto_tpu_torch.models import ifrnet as P
    from moephoto_tpu_torch.progress import Node

    opt = P.IFRNetOpt()
    opt.model, opt.dtype = model, torch.float32
    opt.sf, opt.ensemble, opt.dedupe, opt.dedupeLow, opt.dedupeHigh = sf, ensemble, dedupe, 0.58, 0.993
    f = P.doSlomo(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    outs = []
    for fr in _clip():
        outs.extend(f(torch.from_numpy(fr)))
    return outs + f(None)


@pytest.mark.parametrize("sf,ensemble,dedupe,count", [
    (2.5, 0, False, 13),  # k alternates 1, 2: the mixed-k path, pair by pair
    (2.0, 3, False, 11),  # flow TTA: its transposed decodes run gathered
    (2.0, 0, True, 11),  # the deduper reads gathered level-0 features
], ids=["sf2.5", "ensemble3", "dedupe"])
def test_do_slomo_paths_on_mesh_match_single_device(sf, ensemble, dedupe, count, monkeypatch):
    """The slomo stream graph's other paths on the [8] mesh against its
    single-device run, on the clip and weights of ``tests/test_torch_ifrnet.py``
    (a duplicate and two scene cuts at its thresholds): the same frames,
    within 3e-5."""
    from moephoto_tpu_torch.models import ifrnet as P

    monkeypatch.setattr(P, "GATHER_FROM_LEVEL", 5)
    _, model = _ifrnet(3.0)
    single = _slomo(model, sf, ensemble, dedupe)
    M.installMesh(M.makeMesh([8], devices=CPU8))
    S.resetStats()
    try:
        multi = _slomo(model, sf, ensemble, dedupe)
    finally:
        M.installMesh(None)
    assert len(multi) == len(single) == count
    assert S.stats["hostReads"] > 0 and S.stats["gathers"] > 0
    for a, b in zip(multi, single):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=1e-5)


def test_cli_video_slomo_on_mesh_matches_single_device(tmp_path, monkeypatch):
    """5 frames of 64x64 through ``cli video`` (fake ffmpeg) with IFRNet-S
    slomo x2, with and without a [8] mesh: 9 frames each, every 16-bit value
    within 1 LSB; the mesh run counts its gathered segments and host reads."""
    from moephoto_tpu_torch import cli
    from moephoto_tpu_torch.synth import synthIFRNetParams
    from moephoto_tpu_torch.video import engine

    (tmp_path / "IFRNet").mkdir()
    torch.save(synthIFRNetParams("S", 3), str(tmp_path / "IFRNet" / "IFRNet_S_GoPro.pth"))
    ff = tmp_path / "ffmpeg"
    ff.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.join(ROOT, "tools", "fakeffmpeg.py")}" "$@"\n')
    ff.chmod(0o755)
    for key, value in (("modelDir", str(tmp_path)), ("ffmpegPath", str(ff)), ("opsPath", str(tmp_path / "o.json")),
                       ("device", "cpu")):
        monkeypatch.setattr(config, key, value)
    monkeypatch.setenv("FAKEFF_FRAMES", "5")
    monkeypatch.setenv("FAKEFF_SIZE", "64x64")
    prepare = engine.prepare

    def capturing(store):
        def prep(*args):
            p = prepare(*args)
            process = p["process"]

            def record(item):
                bufs = process(item)
                store.extend(b for b in bufs or () if b)
                return bufs

            p["process"] = record
            return p

        return prep

    outs = {}
    try:
        for name, mesh in (("single", None), ("mesh", M.makeMesh([8], devices=CPU8))):
            M.installMesh(mesh)
            S.resetStats()
            store = []
            monkeypatch.setattr(engine, "prepare", capturing(store))
            path, frames = cli.runVideo(str(tmp_path / "in.mkv"), str(tmp_path / f"{name}.mkv"),
                                        [{"op": "slomo", "model": "IFRNet S", "sf": 2}])
            with open(path) as fp:
                assert (frames, json.load(fp)) == (5, {"bytes": 9 * 64 * 64 * 6, "s": "64x64"})
            outs[name] = np.stack([np.frombuffer(b, np.uint16) for b in store]).astype(np.int64)
            if mesh is not None:
                assert S.stats["hostReads"] == 4 * 4 and S.stats["gathers"] > 0  # 4 pairs, 8 warps, 2 a read
    finally:
        M.installMesh(None)
    assert outs["single"].shape == outs["mesh"].shape == (9, 64 * 64 * 3)
    assert np.abs(outs["single"] - outs["mesh"]).max() <= 1


# --- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_kernels_bit_equal_on_the_card(card, n):
    """K2a, K3's tier and K6 on ``cuda:0`` x n against the single-device
    kernels, bit-equal, each shard a launch of its own."""
    devs = [card] * n
    g = torch.Generator(device=card).manual_seed(n)
    for dtype in (torch.float32, torch.bfloat16):
        img = torch.rand((2, 272, 480, 48), generator=g, device=card).to(dtype)
        flow = (torch.rand((2, 272, 480, 2), generator=g, device=card) * 2 - 1) * 30
        flow[0, 7, 9] = float("nan")
        sh = lambda t: S.RowShards.split(t, devs, 1, 16)
        for mode in ("border", "zeros"):
            before = W.warpSpmd.launches
            _equal(W.warpSpmd(sh(img), sh(flow), mode).gather(), W.warp(img, flow, mode))
            assert W.warpSpmd.launches == before + n
        _equal(W.backWarpSpmd(sh(img), sh(flow)).gather(), W.backWarp(img, flow))
        x = torch.rand((2, 96, 160, 64), generator=g, device=card).to(dtype)
        off = (torch.rand((2, 96, 160, 144), generator=g, device=card) - 0.5) * 20
        m = torch.rand((2, 96, 160, 72), generator=g, device=card)
        wgt = torch.randn((64, 64, 3, 3), generator=g, device=card) * 0.05
        bias = torch.randn((64,), generator=g, device=card)
        before = D.deformConv2dSpmd.launches
        got = D.deformConv2dSpmd(sh(x), sh(off), sh(m), wgt, bias, 8).gather()
        assert D.deformConv2dSpmd.launches == before + n
        _equal(got, D.deformConv2d(x, off, m, wgt, bias, 8))
        limg = torch.rand((1, 1088, 1920, 3), generator=g, device=card) * 1.4 - 0.2
        lut = torch.rand((1, 3, 33, 33, 33), generator=g, device=card)
        vert = torch.nn.functional.pad(torch.rand((1, 3, 32), generator=g, device=card).softmax(-1).cumsum(-1), (1, 0))
        _equal(L.ailutTransformSpmd(sh(limg), lut, vert).gather(), L.ailutTransform(limg, lut, vert))


@pytest.mark.cuda
def test_cuda_shards_raise_without_the_kernel(card, monkeypatch):
    """A CUDA shard launches its kernel or raises: with the build failing,
    the sharded warp raises instead of taking the plain version."""
    from moephoto_tpu_torch.ops import _build

    def fail(source):
        raise RuntimeError(f"no build of {source}")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(_build, "_libs", {})
    img = torch.rand((1, 64, 40, 3), device=card)
    flow = torch.zeros((1, 64, 40, 2), device=card)
    sh = lambda t: S.RowShards.split(t, [card] * 2, 1)
    with pytest.raises(RuntimeError, match="no build"):
        W.warpSpmd(sh(img), sh(flow))


@pytest.fixture
def cards(monkeypatch):
    """Every card of the machine, two or more, with ``config.device`` the card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    monkeypatch.setattr(config, "device", "cuda")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.cuda
def test_mesh_across_cards_matches_one_card(cards, monkeypatch):
    """A mesh of every card: each shard's kernel runs on its own card and the
    halos are peer copies.  K2a, K3's tier and K6 are bit-equal to the
    single-device kernels on ``cuda:0``; lite x2 through ``ModelExec`` under
    ``meshShape`` [n] gives the single-device output with every card taking
    tile calls; IFRNet-S's, IconVSR's and ESTRNN's row-sharded stages (fp32,
    TF32 off, every segment whose shards hold its reach sharded) match the
    single-device stages within the CPU tests' tolerances."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.engine.tiling import TileSpec
    from moephoto_tpu_torch.models import ifrnet as P
    from moephoto_tpu_torch.models.sr import moeNetLite2x2
    from moephoto_tpu_torch.synth import synthLite2Params

    n, home = len(cards), cards[0]
    g = torch.Generator(device=home).manual_seed(n)
    sh = lambda t: S.RowShards.split(t, cards, 1, 16)
    img = torch.rand((2, 272, 480, 48), generator=g, device=home).to(torch.bfloat16)
    flow = (torch.rand((2, 272, 480, 2), generator=g, device=home) * 2 - 1) * 30
    for mode in ("border", "zeros"):
        _equal(W.warpSpmd(sh(img), sh(flow), mode).gather(), W.warp(img, flow, mode))
    x = torch.rand((2, 96, 160, 64), generator=g, device=home).to(torch.bfloat16)
    off = (torch.rand((2, 96, 160, 144), generator=g, device=home) - 0.5) * 20
    m = torch.rand((2, 96, 160, 72), generator=g, device=home)
    wgt = torch.randn((64, 64, 3, 3), generator=g, device=home) * 0.05
    bias = torch.randn((64,), generator=g, device=home)
    _equal(D.deformConv2dSpmd(sh(x), sh(off), sh(m), wgt, bias, 8).gather(), D.deformConv2d(x, off, m, wgt, bias, 8))
    limg = torch.rand((1, 272, 480, 3), generator=g, device=home) * 1.4 - 0.2
    lut = torch.rand((1, 3, 33, 33, 33), generator=g, device=home)
    vert = torch.nn.functional.pad(torch.rand((1, 3, 32), generator=g, device=home).softmax(-1).cumsum(-1), (1, 0))
    _equal(L.ailutTransformSpmd(sh(limg), lut, vert).gather(), L.ailutTransform(limg, lut, vert))

    lite = moeNetLite2x2()
    lite.load_state_dict(synthLite2Params(2, 0))
    ex = ModelExec(lite.eval().to(home), TileSpec(64, 4, 8, 2.0, 2), dtype=torch.float32, name="t", device=home)
    plane = np.random.RandomState(0).rand(150, 140, 1).astype(np.float32)
    single = ex(plane)
    M.installMesh(M.makeMesh([n], devices=cards))
    S.resetStats()
    try:
        multi = ex(plane)
        calls = dict(S.stats["tileCalls"])
    finally:
        M.installMesh(None)
    assert set(calls) == set(range(min(n, 5))), calls  # 9 tiles, 2 a call
    torch.testing.assert_close(multi, single, atol=1e-6, rtol=0)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(P, "GATHER_FROM_LEVEL", 5)
    _, model = _ifrnet(3.0)
    model.to(home)
    frames = torch.from_numpy(np.random.RandomState(8).rand(3, 256, 64, 3).astype(np.float32)).to(home)

    def stages():
        with torch.inference_mode():
            mean, inpN, feats = model.encodeFull(frames)
            feats = [f.gather() if isinstance(f, S.RowShards) else f for f in feats]
            f = [torch.stack([torch.stack([lv[0], lv[1]]), torch.stack([lv[1], lv[2]])]) for lv in feats]
            preds = model.decodePost(f, torch.tensor([[0.25], [0.5]], device=home),
                                     torch.stack([inpN[0:2], inpN[1:3]]), torch.stack([mean[0:2], mean[1:3]]))
        return [mean, inpN] + feats + [preds]

    single = stages()
    M.installMesh(M.makeMesh([n], devices=cards))
    S.resetStats()
    try:
        multi = stages()
        assert S.stats["haloBytes"] > 0
    finally:
        M.installMesh(None)
    for name, a, b in zip(NAMES, multi, single):
        assert a.device == home, name
        torch.testing.assert_close(a, b, atol=3e-5 if name == "preds" else 2e-5, rtol=1e-5, msg=name)
    # IconVSR's and ESTRNN's row-sharded stages (fp32, TF32 off, IconVSR's
    # GATHER_FROM off) against the one card, within the CPU tests' tolerance
    from fractions import Fraction

    from moephoto_tpu_torch.models import estrnn as E
    from moephoto_tpu_torch.models import iconvsr as V
    from moephoto_tpu_torch.synth import synthESTRNNParams, synthIconVSRParams

    monkeypatch.setattr(V, "GATHER_FROM", Fraction(0))
    vsr = V.IconVSR(2)
    vsr.load_state_dict({f"{m}.{k}": v for m, d in synthIconVSRParams(0, 2).items() for k, v in d.items()})
    est = E.ESTRNN()
    est.load_state_dict({f"{m}.{k}": v for m, d in synthESTRNNParams(0).items() for k, v in d.items()})
    vsr.eval().to(home)
    est.eval().to(home)
    rng = np.random.RandomState(9)
    r = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32)).to(home)  # noqa: E731
    inp, pair, clip, kf = r(3, 256, 64, 3), r(2, 2, 256, 64, 3), r(1, 7, 256, 64, 3), r(1, 256, 64, 64) * 0.1
    flow, frames, hidden = (r(3, 256, 64, 2) * 2 - 1) * 3, r(6, 384, 32, 3), r(1, 96, 8, 16) * 0.1
    whole = lambda x: x.gather() if isinstance(x, S.RowShards) else x  # noqa: E731

    def videoStages():
        with torch.inference_mode():
            bwd = vsr.backwardScan(inp, flow, [False, True, True], [kf, None, None])
            fwd, fp = vsr.forwardScan(kf, inp, [V.rowsOf(bwd, t) for t in range(3)], flow, [False, True, True],
                                      [None, kf, None])
            hs, w, h2 = est.cellScanPool(frames, hidden)
            hsW = whole(hs)
            out = est.gsaRecons(torch.stack([hsW[0:5], hsW[1:6]]), torch.stack([w[0:5], w[1:6]]))
            return {k: whole(v) for k, v in dict(spynet=vsr.spynet(pair), edvr=vsr.edvr(clip), backward=bwd,
                                                 forward=fwd, carry=fp, upsample=vsr.upsampleChunk(inp, fwd),
                                                 hs=hsW, w=w, hidden=h2, deblurred=out).items()}

    single = videoStages()
    M.installMesh(M.makeMesh([n], devices=cards))
    S.resetStats()
    try:
        multi = videoStages()
        assert S.stats["haloBytes"] > 0
    finally:
        M.installMesh(None)
    for name in single:
        assert multi[name].device == home, name
        torch.testing.assert_close(multi[name], single[name], atol=2e-5, rtol=1e-5, msg=name)
