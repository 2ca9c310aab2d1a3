"""The row-sharded video stages of IconVSR and ESTRNN (the port's
``rowStage`` forms of the JAX package's ``spyJit``, ``edvrJit``,
``bScanJit``, ``fScanJit``, ``upJit``, ``cellScanPoolJit`` and
``gsaReconsJit``) against the port's single-device stages on ``cpu`` x 2
and x 4 meshes, and against the JAX package's stages on its [8] mesh of
virtual CPU devices; the ``doVSR`` and ``doESTRNN`` streams on a mesh.

Tolerance 2e-5 abs / 1e-5 rel, that of ``tests/test_parallel.py``.  The
sizes are picked so that every stage runs at least one segment sharded
(``sharded.stats["gathers"]`` counts the gathered ones); the rules that
gather segments whatever their size (IconVSR's ``GATHER_FROM``, segments at
1/4 of the frame's rows or coarser, and ``GATHER_TSA``; ESTRNN's
``GATHER_ENCODER``) are switched off where a test says so, so that the
sharded forms of those segments are held too.  On the CPU every shard takes the
kernels' plain versions, through the sharded wrappers (K2a
``backWarpSpmd``, K3's tier ``deformConv2dSpmd``)."""

import contextlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.parallel import mesh as jaxMesh
from moephoto_tpu.parallel import temporal as jaxTemporal
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models import estrnn as E
from moephoto_tpu_torch.models import iconvsr as V
from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.ops import deform as D
from moephoto_tpu_torch.parallel import mesh as M
from moephoto_tpu_torch.parallel import sharded as S
from moephoto_tpu_torch.progress import Node
from moephoto_tpu_torch.synth import synthESTRNNParams, synthIconVSRParams
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ATOL, RTOL = 2e-5, 1e-5
MESHES = [2, 4]


@pytest.fixture(autouse=True)
def cpuDevice(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


@contextlib.contextmanager
def portMesh(n):
    """The port's mesh of n CPU entries (None: single device), stats reset;
    cleared after."""
    M.installMesh(M.makeMesh([n], devices=["cpu"] * n) if n else None)
    S.resetStats()
    try:
        yield
    finally:
        M.installMesh(None)


@contextlib.contextmanager
def jaxCpuMesh(shape):
    """The JAX package's mesh on its virtual CPU devices; restored after."""
    old = (jaxConfig.meshShape, getattr(jaxConfig, "meshBackend", ""))
    jaxConfig.meshShape, jaxConfig.meshBackend = list(shape), "cpu"
    jaxMesh._activeMesh[:] = [None, None]
    jaxTemporal._videoMesh[:] = [None, None]
    try:
        assert jaxTemporal.videoMesh() is not None
        yield
    finally:
        jaxConfig.meshShape, jaxConfig.meshBackend = old
        jaxMesh._activeMesh[:] = [None, None]
        jaxTemporal._videoMesh[:] = [None, None]


class Calls:
    """While entered: the calls of K2a's ``backWarpSpmd`` and K3's tier
    ``deformConv2dSpmd`` from the model modules."""

    def __init__(self, monkeypatch):
        self.n = {"backWarpSpmd": 0, "deformConv2dSpmd": 0}
        for mod, name in ((V, "backWarpSpmd"), (D, "deformConv2dSpmd")):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, orig=orig, name=name, **k: self._count(name) or orig(*a, **k))

    def _count(self, name):
        self.n[name] += 1


def _whole(x):
    return x.gather() if isinstance(x, S.RowShards) else x


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


# --- IconVSR --------------------------------------------------------------------


@pytest.fixture(scope="module")
def vsr():
    """IconVSR with 2-block trunks (synthIconVSRParams), inputs of 3 frames of
    128 rows (64 a shard on [2], 32 on [4]; 32 columns, 64 for SpyNet's
    pair, whose coarsest level has 1/32 of them) and its single-device
    stages."""
    raw = synthIconVSRParams(0, 2)
    model = V.IconVSR(2)
    model.load_state_dict({f"{m}.{k}": v for m, d in raw.items() for k, v in d.items()}, strict=True)
    rng = np.random.RandomState(1)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.rand(*s) * scale).astype(np.float32))  # noqa: E731
    T, H, W = 3, 128, 32
    inputs = dict(inp=t(T, H, W, 3), pair=t(2, 2, H, 2 * W, 3), clip=t(1, 7, H, W, 3),
                  flow=(t(T, H, W, 2) * 2 - 1) * 3, kf=t(1, H, W, 64, scale=0.1),
                  featProp=t(1, H, W, 64, scale=0.1))
    model.eval()
    return model, inputs, _vsrStages(model, inputs)


def _vsrStages(model, x):
    """SpyNet, EDVR, both scans with keyframes, the upsampler."""
    with torch.inference_mode():
        spy = model.spynet(x["pair"])
        edvr = model.edvr(x["clip"])
        bwd = model.backwardScan(x["inp"], x["flow"], [False, True, True], [x["kf"], None, None])
        fwd, fp = model.forwardScan(x["featProp"], x["inp"], [V.rowsOf(bwd, t) for t in range(3)], x["flow"],
                                    [False, True, True], [None, x["kf"], None])
        up = model.upsampleChunk(x["inp"], fwd)
    return {k: _whole(v) for k, v in dict(spynet=spy, edvr=edvr, backward=bwd, forward=fwd, forwardCarry=fp,
                                          upsample=up).items()}


@pytest.mark.parametrize("n,small", [(2, 3), (4, 4)])
def test_iconvsr_stages_on_mesh_match_single_device(vsr, n, small, monkeypatch):
    """Every stage on the [n] mesh against the single-device stage, with
    GATHER_FROM and GATHER_TSA off: K2a at all six SpyNet levels and for
    both scans' two warps each, K3's tier for EDVR's four DCNs, one host
    read of the reach a warp call, a DCN or a scan.  Every SpyNet level's
    up-sampled flow is computed whole, and the levels whose shards are
    shorter than the basic module's 15 rows (``small``: 2, 4 and 8 rows on
    [2], also 16 on [4]) run it gathered; everything else, TSA included,
    runs sharded."""
    model, x, single = vsr
    monkeypatch.setattr(V, "GATHER_FROM", Fraction(0))
    monkeypatch.setattr(V, "GATHER_TSA", False)
    calls = Calls(monkeypatch)
    with portMesh(n):
        multi = _vsrStages(model, x)
        stats = dict(S.stats)
    assert stats["gathers"] == 6 + small and stats["haloBytes"] > 0
    assert calls.n == {"backWarpSpmd": 6 + 2 + 2, "deformConv2dSpmd": 4}
    assert stats["hostReads"] == 6 + 4 + 2
    for name in single:
        _close(multi[name], single[name], name)


def test_iconvsr_shipped_gather_rule(vsr, monkeypatch):
    """With the shipped rules on [4] (GATHER_FROM 1/4, GATHER_TSA): SpyNet's
    four coarsest levels, EDVR's L3 segments and TSA run gathered, the rest
    sharded, and the stages still match the single-device ones; K3's tier
    still takes all four DCNs."""
    model, x, single = vsr
    calls = Calls(monkeypatch)
    with portMesh(4):
        multi = _vsrStages(model, x)
        stats = dict(S.stats)
    assert stats["gathers"] == 6 + 2 + 1 and calls.n["deformConv2dSpmd"] == 4  # SpyNet's 6 levels, L3's 2, TSA
    for name in single:
        _close(multi[name], single[name], name)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_back_warp_spmd_with_a_scan_reach_equals_single_device(mode):
    """``backWarpSpmd`` given ``reach`` (what a sharded scan passes: the
    ``rowReach`` of all its flows, read once) reads no reach of its own and
    is bit-equal to ``backWarp`` on [4] (16-row shards): for flows that move
    rows across shards, and for one that moves a fraction of a row under
    the scan's larger reach."""
    from moephoto_tpu_torch.ops import warp as W

    rng = np.random.RandomState(4)
    img = torch.from_numpy(rng.rand(1, 64, 24, 8).astype(np.float32))
    flows = torch.from_numpy(((rng.rand(3, 64, 24, 2) - 0.5) * np.float32([4, 40])).astype(np.float32))
    reach = W.rowReach([flows], 1)
    split = lambda t: S.RowShards.split(t, [torch.device("cpu")] * 4, 1)  # noqa: E731
    for flow in (flows[:1], flows[2:], flows[1:2] * 0.01):
        S.resetStats()
        got = W.backWarpSpmd(split(img), split(flow), mode, reach).gather()
        assert S.stats["hostReads"] == 0 and reach > 16
        assert torch.equal(got, W.backWarp(img, flow, mode))


def test_checking_segments_counts_each_sharded_segment_of_edvr(vsr):
    """Under ``sharded.checkingSegments`` (what holds the gather rules on the
    card) EDVR on [2] with the shipped rules gives the same features bit for
    bit, and each of the nine segments it runs sharded (the extraction, both
    stride-2 levels, PCD's L2 offsets, feat_conv and resize, L1's offsets and
    feat_conv, the cascade) is run whole once beside it; the three gathered
    ones (L3's two, TSA) are not."""
    model, x, _ = vsr
    with portMesh(2), torch.inference_mode():
        plain = _whole(model.edvr(x["clip"]))
        S.resetStats()
        with S.checkingSegments():
            checked = _whole(model.edvr(x["clip"]))
        stats = dict(S.stats)
    assert torch.equal(plain, checked)
    assert stats["gathers"] == 3 and len(stats["segments"]) == 9
    assert all(calls == 1 for calls, _ in stats["segments"].values())


@pytest.mark.parametrize("halo,differing", [(1, 0), (0, 1)])
def test_checking_segments_finds_a_segment_that_differs(halo, differing):
    """A 3-row box sum on small integers is exact, so run sharded with its
    reach (1 row) as the halo it equals its whole run in every bit, and one
    row short it does not: ``checkingSegments`` counts the call and whether
    it differed, and the output stays the sharded one."""
    def box(v):  # each row plus its two neighbours, zeros past the edges
        p = torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
        return p[:, :-2] + p[:, 1:-1] + p[:, 2:]

    x = torch.from_numpy(np.random.RandomState(3).randint(0, 9, (2, 32, 5, 3)).astype(np.float32))
    xs = S.RowShards.split(x, [torch.device("cpu")] * 4, 1)
    S.resetStats()
    with S.checkingSegments():
        got = S.rowSegment(box, xs, halo).gather()
    (key, calls), = S.stats["segments"].items()
    assert calls == [1, differing] and key == f"{box.__qualname__} in [2, 32, 5, 3] halo {halo} scale 1"
    assert torch.equal(got, S.rowSegment(box, xs, halo).gather())
    assert torch.equal(got, box(x)) == (not differing)


@pytest.mark.parametrize("name,cut", [("trunk", "step"), ("spynet", "SPY_HALO"), ("upsample", "UP_HALO")])
def test_iconvsr_halo_is_not_understated(vsr, name, cut, monkeypatch):
    """A recurrence step's, SpyNet's or the upsampler's halo one row short
    moves its stage's output far beyond the tolerance on [4], so an
    understated reach cannot pass by accident.  (With the damped random
    weights a row far away moves the deep segments, TSA and ESTRNN's RDNet,
    by less than an fp32 rounding: their reach is held by its derivation in
    the models' comments.)"""
    model, x, single = vsr
    monkeypatch.setattr(V, "GATHER_FROM", Fraction(0))
    monkeypatch.setattr(V, "GATHER_TSA", False)
    if cut == "step":
        orig = S.rowSegment
        monkeypatch.setattr(V, "rowSegment", lambda fn, v, halo, *a, **k: orig(fn, v, halo - 1, *a, **k)
                            if fn.__name__ == "step" else orig(fn, v, halo, *a, **k))
    else:
        monkeypatch.setattr(V, cut, getattr(V, cut) - 1)
    stage = {"trunk": ("backward", lambda: model.backwardScan(x["inp"], x["flow"], [False, True, True],
                                                              [x["kf"], None, None])),
             "spynet": ("spynet", lambda: model.spynet(x["pair"])),
             "upsample": ("upsample", lambda: model.upsampleChunk(x["inp"], single["forward"]))}
    key, run = stage[name]
    with portMesh(4), torch.inference_mode():
        got = _whole(run())
    assert np.abs(np.asarray(got) - np.asarray(single[key])).max() > 1e-4


def test_iconvsr_stages_match_jax_mesh(monkeypatch):
    """SpyNet, both scans and the upsampler on the port's [8] mesh against the
    JAX package's ``spyJit``, ``bScanJit``, ``fScanJit`` and ``upJit`` on its
    [8] mesh, at ``synthParams(numBlocks=2)`` and the inputs of
    ``tests/test_parallel.py`` (3 frames of 64x64); EDVR's weights are not in
    JAX's ``synthParams``, which leaves it out."""
    import jax.numpy as jnp

    from moephoto_tpu.models import iconvsr as J

    params = J.synthParams(seed=0, numBlocks=2)
    trunk = J.trunkApply
    monkeypatch.setattr(J, "trunkApply", lambda p, prefix, x, numBlocks=2: trunk(p, prefix, x, 2))
    model = V.IconVSR(2)
    missing = model.load_state_dict(fromJaxParams({k: np.asarray(v) for k, v in params.items()}), strict=False)
    assert all(k.startswith("edvr.") for k in missing.missing_keys)
    model.eval()
    rng = np.random.RandomState(1)
    T, H, W = 3, 64, 64
    inp = rng.rand(T, H, W, 3).astype(np.float32)
    flow = (rng.rand(T, H, W, 2) * 2 - 1).astype(np.float32)
    kfStack = (rng.rand(1, H, W, V.NumFeat) * 0.1).astype(np.float32)
    pair = rng.rand(2, 2, H, W, 3).astype(np.float32)
    featProp = (rng.rand(1, H, W, V.NumFeat) * 0.1).astype(np.float32)
    upFeat = (rng.rand(2, H, W, V.NumFeat) * 0.1).astype(np.float32)
    kfMask, warpMask = [True, False, False], [False, True, True]
    with jaxCpuMesh([8]):
        a = lambda v: jnp.asarray(v)  # noqa: E731
        kfIdx, valid = jnp.zeros((T,), np.int32), jnp.ones((T,), bool)
        b = J.bScanJit(params, a(inp), a(flow), a(kfStack), kfIdx, a(kfMask), a(warpMask), valid)
        f, fp = J.fScanJit(params, a(featProp), a(inp), b, a(flow), a(kfStack), kfIdx, a(warpMask), a(kfMask), valid)
        ref = dict(backward=b, forward=f, forwardCarry=fp, spynet=J.spyJit(params, a(pair)),
                   upsample=J.upJit(params, a(inp[:2]), a(upFeat)))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    t = torch.from_numpy
    kfs = [t(kfStack) if m else None for m in kfMask]
    with portMesh(8), torch.inference_mode():
        bwd = model.backwardScan(t(inp), t(flow), warpMask, kfs)
        fwd, fpOut = model.forwardScan(t(featProp), t(inp), [V.rowsOf(bwd, i) for i in range(T)], t(flow), warpMask,
                                       kfs)
        got = dict(backward=bwd, forward=fwd, forwardCarry=fpOut, spynet=model.spynet(t(pair)),
                   upsample=model.upsampleChunk(t(inp[:2]), t(upFeat)))
        got = {k: _whole(v) for k, v in got.items()}
    for name in ref:
        _close(got[name], ref[name], name)


def _vsrFrames():
    rng = np.random.RandomState(5)
    base = rng.rand(160, 64, 3).astype(np.float32)
    return [0.8 * np.roll(base, (i, -i), axis=(0, 1))[:128, :40] + 0.2 * rng.rand(128, 40, 3).astype(np.float32)
            for i in range(7)]


def _runVsr(model):
    opt = V.VSROpt()
    opt.model, opt.dtype, opt.start = model, torch.float32, 3
    f = V.doVSR(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    outs = []
    for fr in _vsrFrames():
        outs.extend(f(torch.from_numpy(fr)))
    opt.end = -3
    return outs + f(None)


def test_do_vsr_on_mesh_matches_single_device(vsr, monkeypatch):
    """The VSR stream on 7 frames of 128x40 on the [4] mesh (shipped gather
    rule) against its single-device run: the same 7 frames at 512x160,
    within the tolerance; EDVR's DCNs through K3's tier, every warp through
    K2a."""
    model = vsr[0]
    single = _runVsr(model)
    calls, edvrCalls = Calls(monkeypatch), model.edvr.calls
    with portMesh(4):
        multi = _runVsr(model)
    assert len(multi) == len(single) == 7
    assert calls.n["deformConv2dSpmd"] == 4 * (model.edvr.calls - edvrCalls) > 0 and calls.n["backWarpSpmd"] > 0
    for a, b in zip(multi, single):
        assert a.shape == (512, 160, 3)
        _close(a, b, "frame")


# --- ESTRNN ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def estrnn():
    raw = synthESTRNNParams(0)
    model = E.ESTRNN()
    model.load_state_dict({f"{m}.{k}": v for m, d in raw.items() for k, v in d.items()}, strict=True)
    return model.eval()


def _estrnnStages(model, H, W, seed=3):
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(rng.rand(6, H, W, 3).astype(np.float32))
    hidden = torch.from_numpy((rng.rand(1, H // 4, W // 4, E.NumFeat) * 0.1).astype(np.float32))
    with torch.inference_mode():
        hs, w, h2 = model.cellScanPool(frames, hidden)
        whole = _whole(hs)
        out = model.gsaRecons(torch.stack([whole[0:5], whole[1:6]]), torch.stack([w[0:5], w[1:6]]))
    return dict(hs=whole, w=w, hidden=_whole(h2), out=out), isinstance(hs, S.RowShards)


@pytest.mark.parametrize("n,H,W,gatherEncoder,gathers", [(2, 128, 32, True, 12), (4, 128, 32, True, 12),
                                                         (2, 384, 16, False, 0)],
                         ids=["2_rdnet_gathered", "4_rdnet_gathered", "2_all_sharded"])
def test_estrnn_stages_on_mesh_match_single_device(estrnn, n, H, W, gatherEncoder, gathers, monkeypatch):
    """The recurrence with the pooled weights and GSA + reconstructor on the
    [n] mesh against single-device: the hidden path and the reconstructor
    sharded; the encoder gathered (the shipped GATHER_ENCODER) but for the
    last case, which shards it; the RDNet (46 rows of reach at 1/4)
    gathered on shards of 16 and 8 feature rows and sharded on 48 (384 rows
    on [2]); the features and the hidden state stay row shards."""
    monkeypatch.setattr(E, "GATHER_ENCODER", gatherEncoder)
    single, _ = _estrnnStages(estrnn, H, W)
    with portMesh(n):
        multi, isShards = _estrnnStages(estrnn, H, W)
        stats = dict(S.stats)
    assert isShards and stats["gathers"] == gathers and stats["haloBytes"] > 0
    for name in single:
        _close(multi[name], single[name], name)


def test_estrnn_stages_match_jax_mesh(estrnn):
    """``cellScanPool`` and ``gsaRecons`` on the port's [8] mesh against the
    JAX package's ``cellScanPoolJit`` and ``gsaReconsJit`` on its [8] mesh,
    at the inputs of ``tests/test_parallel.py`` (6 frames of 64x64)."""
    import jax.numpy as jnp

    from moephoto_tpu.models import estrnn as J

    params = J.synthParams(seed=0)
    rng = np.random.RandomState(3)
    frames = rng.rand(6, 64, 64, 3).astype(np.float32)
    hidden = (rng.rand(1, 16, 16, E.NumFeat) * 0.1).astype(np.float32)
    with jaxCpuMesh([8]):
        hs, w, h2 = J.cellScanPoolJit(params, jnp.asarray(frames), jnp.asarray(hidden))
        out = J.gsaReconsJit(params, jnp.stack([hs[0:5], hs[1:6]]), jnp.stack([w[0:5], w[1:6]]))
        ref = dict(hs=np.asarray(hs), w=np.asarray(w), hidden=np.asarray(h2), out=np.asarray(out))
    with portMesh(8), torch.inference_mode():
        ghs, gw, gh2 = estrnn.cellScanPool(torch.from_numpy(frames), torch.from_numpy(hidden))
        ghs = _whole(ghs)
        gout = estrnn.gsaRecons(torch.stack([ghs[0:5], ghs[1:6]]), torch.stack([gw[0:5], gw[1:6]]))
    for name, got in dict(hs=ghs, w=gw, hidden=_whole(gh2), out=gout).items():
        _close(got, ref[name], name)


def _runEstrnn(model, n):
    opt = E.ESTRNNOpt()
    opt.model, opt.dtype, opt.start = model, torch.float32, 2
    f = E.doESTRNN(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    rng = np.random.RandomState(7)
    outs = []
    for _ in range(n):
        outs.extend(f(torch.from_numpy(rng.rand(128, 40, 3).astype(np.float32))))
    opt.end = -2
    return outs + f(None)


@pytest.mark.parametrize("n", MESHES)
def test_do_estrnn_on_mesh_matches_single_device(estrnn, n):
    """The deblur stream on 11 frames of 128x40 (two recurrence chunks, the
    hidden state carried across them as row shards) on the [n] mesh against
    its single-device run: 11 frames, within the tolerance."""
    single = _runEstrnn(estrnn, 11)
    with portMesh(n):
        multi = _runEstrnn(estrnn, 11)
    assert len(multi) == len(single) == 11
    for a, b in zip(multi, single):
        assert a.shape == (128, 40, 3)
        _close(a, b, "frame")
