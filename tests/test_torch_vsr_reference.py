"""The port's IconVSR and its VSR stream (``moephoto_tpu_torch/models/iconvsr.py``)
against the benchmark's plain reference (``benchmark/reference/iconvsr.py``)
on the CPU in fp32, with weights drawn by the benchmark cell's own rule
(``benchmark/configs/iconvsr_x4.json``: DCN offsets of a few pixels, flows
within a few pixels) at the published widths, the trunks at one residual
block; and the departures from BasicSR that the reference states.

EDVR and SpyNet are compared on their own.  The 24-frame stream (a
backward restart at frame 20; keyframes at 0, 7, 14, 19, 20, 21 and 23,
20 for the end of the stream's first batch of full windows; the crop of
the 64-aligned pad) runs with one stand-in for EDVR on both
sides, a fixed projection of its clip's seven frames that records which
frames it was given: EDVR at 64 channels on a 64 x 64 clip costs ~3 s a
call on one thread, six calls the stream.

Tolerances, both sides fp32 and computing the same operations in sums of
another order (grid_sample against the port's gather warp, a strided
contraction against a product per tap): features within 1e-4 relative,
since a warp or a DCN turns a last-bit difference of a coordinate into a
value difference of that size times the local gradient; 16-bit outputs
within 2 steps and 0.25 RMS, since the output step truncates and a
value at a step's edge moves one step for a difference of 1e-7.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import spec
from benchmark.harness import trace as tracing
from benchmark.harness.cell import Item, Run, Window
from benchmark.harness.traffic import makeClip
from benchmark.harness.weights import drawWeights
from benchmark.reference import iconvsr as R
from benchmark.reference.ifrnet import frameFromBytes, toBytes16
from moephoto_tpu_torch.models import iconvsr as P
from moephoto_tpu_torch.ops.deform import deformConv2dPlain
from moephoto_tpu_torch.ops.warp import backWarp
from moephoto_tpu_torch.progress import Node
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS, H, W, N, SEED = 1, 40, 48, 24, 2**31 + 18
KEEP = (0, 7, 19, 20, 23)  # the first frame, a keyframe, the chunk's end and restart, the last
FEAT_TOL, LSB_MAX, LSB_RMS = 1e-4, 2.0, 0.25


def _close(got, ref, tol=FEAT_TOL):
    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    assert got.shape == ref.shape
    err = (got - ref).abs()
    assert bool((err <= tol * ref.abs().clamp(min=1.0)).all()), float(err.max())


@pytest.fixture(scope="module")
def models():
    """(reference, port) with one set of weights, the port's loaded from the
    nested checkpoint ``reference.checkpoint`` writes."""
    with open(os.path.join(ROOT, "benchmark", "configs", "iconvsr_x4.json")) as fp:
        rule = json.load(fp)["weights"]
    ref = R.IconVSR(BLOCKS)
    sd = drawWeights(ref, rule, SEED, "cpu", torch.float32)
    ref.load_state_dict(sd)
    flat = {f"{mod}.{k}": v for mod, msd in R.checkpoint(sd).items() for k, v in msd.items()}
    port = P.IconVSR(P.trunkBlocks(flat))
    assert not port.load_state_dict(flat, strict=False).missing_keys
    return ref.eval(), port.eval()


@pytest.fixture(scope="module")
def clip():
    frames = makeClip({"width": W, "height": H, "frames": N, "max_speed": 2}, SEED, "cpu")
    return frames, R.alignPad(torch.cat([frameFromBytes(f, H, W, "cpu") for f in frames]))


def _standIns(padded, calls):
    """EDVR stand-ins for the port (NHWC) and the reference (NCHW): the same
    projection of a clip's seven frames to 64 channels; each call records
    its frames' indices."""
    proj = torch.randn(R.NUM_FEAT, R.REF_TIME, 3, generator=torch.Generator().manual_seed(0)) * 0.2
    index = lambda f: next(k for k in range(N) if torch.equal(f, padded[k]))

    def port(self, x):  # (1, 7, H, W, 3)
        calls["port"].append([index(f.permute(2, 0, 1)) for f in x[0]])
        return torch.einsum("bnhwc,onc->bhwo", x.float(), proj)

    def ref(self, x):  # (1, 7, 3, H, W)
        calls["ref"].append([index(f) for f in x[0]])
        return torch.einsum("bnchw,onc->bohw", x, proj)

    return port, ref


@pytest.fixture(scope="module")
def stream(models, clip):
    """The port's stream over the clip (the start and end padding of
    ``video/engine``), traced by the CPU profiler, and the reference's
    ``vsrClip``, both with the EDVR stand-ins."""
    ref, port = models
    frames, padded = clip
    calls = {"port": [], "ref": []}
    standPort, standRef = _standIns(padded, calls)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P.EDVR, "forward", standPort)
        mp.setattr(R.EDVR, "forward", standRef)
        opt = P.VSROpt()
        opt.model, opt.dtype, opt.start = port, torch.float32, 3
        f = P.doVSR(lambda x: None if x is None else [x], Node({"op": "test"}), opt)
        outs = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tracing.WINDOW):
                for raw in frames:
                    outs.extend(f(frameFromBytes(raw, H, W, "cpu")[0].permute(1, 2, 0)))
                opt.end = -3
                outs.extend(f(None))
        want = R.vsrClip(ref, frames, H, W, "cpu", KEEP)
    return outs, want, calls, tracing.fromProfiler(prof)


def test_stream_matches_the_reference(stream):
    """24 frames through the port's stream graph and the reference's
    ``vsrClip``: backward chunks of 20 and 4 frames from zeros, the forward
    state across them, keyframe refills, the x4 output cropped to 160 x 192
    and quantised to 16 bits."""
    outs, want, _, _ = stream
    assert len(outs) == N
    for t in KEEP:
        got = toBytes16(outs[t].permute(2, 0, 1)[None]).astype(np.float64)
        assert got.shape == want[t].shape == (4 * H, 4 * W, 3)
        d = got - want[t]
        assert np.abs(d).max() <= LSB_MAX and np.sqrt((d**2).mean()) <= LSB_RMS, (t, np.abs(d).max())


def test_keyframes_and_windows_match_the_port(stream):
    """EDVR runs at every 7th frame and at the last frame of each batch of
    windows the keyframe stage takes (frames 0-19 while frames arrive; at
    the end of the stream 20, the last full window, then 21-23), on
    MoePhoto's padded 7-frame windows (frames 6, 5, 4 before the first,
    n - 5, n - 6, n - 7 after the last)."""
    _, _, calls, _ = stream
    keys = [t for t in range(N) if R.isKeyframe(t, N)]
    assert keys == [0, 7, 14, 19, 20, 21, 23]
    assert calls["port"] == calls["ref"] == [R.edvrWindow(t, N) for t in keys]
    assert R.edvrWindow(0, N) == [6, 5, 4, 0, 1, 2, 3] and R.edvrWindow(23, N) == [20, 21, 22, 23, 19, 18, 17]


def test_counters_and_spans_read_by_the_benchmark(stream):
    """The stream's counters and spans in the CPU profiler's record, and the
    benchmark's readers of ``keyframes.vsr`` and ``vsr_host_ms.vsr``."""
    outs, _, _, tr = stream
    names = [n for n, _, _ in tr.host]
    assert [n for n in names if n.startswith("moe.count.vsr_")] == [
        "moe.count.vsr_keyframes=4", "moe.count.vsr_frames=20", "moe.count.vsr_keyframes=3", "moe.count.vsr_frames=4"]
    # seven EDVR clips; SpyNet and the scan once a chunk in each direction (20 + 4 frames); 4-frame upsampler batches
    for span, n in (("moe.vsr.edvr", 7), ("moe.vsr.spynet", 4), ("moe.vsr.scan", 4), ("moe.vsr.up", 6)):
        assert names.count(span) == n, span
    run = Run(0.0, Window(*tr.window, items=[Item(0.0, 1.0) for _ in outs]), tr)
    cell = spec.cell("vsr_iconvsr_x4_540p")
    assert cell.reader("keyframes.vsr").read(run) == pytest.approx(7 / 24)
    assert 0 < cell.reader("vsr_host_ms.vsr").read(run) < 1e3 * tr.window_s / len(outs)


def test_edvr_matches_the_port(models):
    """One 7-frame clip at 16 x 24 through EDVR: feature extraction, PCD's
    four DCNs at offsets of a few pixels, TSA."""
    ref, port = models
    x = torch.rand(1, R.REF_TIME, 3, 16, 24, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.edvr(x)
        got = port.edvr(x.permute(0, 1, 3, 4, 2)).permute(0, 3, 1, 2)
    _close(got, want)


def test_spynet_matches_the_port(models, clip):
    ref, port = models
    _, padded = clip
    with torch.no_grad():
        want = ref.spynet(padded[3:4], padded[4:5])
        got = port.spynet(torch.stack([padded[3:4], padded[4:5]], 1).permute(0, 1, 3, 4, 2)).permute(0, 3, 1, 2)
    assert want.abs().max() > 0.1  # the draw gives flows that move pixels
    _close(got, want)


def test_warp_normalises_by_the_size():
    """MoePhoto's warp samples at (x + u)(W - 1)/W (and so in y), BasicSR's
    ``flow_warp`` at x + u: on a ramp the two differ, and the reference's
    and the port's warps agree with the first."""
    h, w, u, v = 6, 10, 1.5, 0.75
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32), indexing="ij")
    img = torch.stack([xs, ys])[None]  # each pixel holds its own (x, y)
    flow = torch.tensor([u, v]).view(1, 2, 1, 1).expand(1, 2, h, w)
    got = R.backWarp(img, flow, "border")
    port = backWarp(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), "border").permute(0, 3, 1, 2)
    want = torch.stack([((xs + u) * (w - 1) / w).clamp(0, w - 1), ((ys + v) * (h - 1) / h).clamp(0, h - 1)])[None]
    _close(got, want, 1e-5)
    _close(port, want, 1e-5)
    assert (want[0, 0] - (xs + u).clamp(0, w - 1)).abs().max() > 0.5


def _loopDcn(x, offset, mask, weight, bias, dg):
    """DCNv2 by its definition, one output value at a time, in float64."""
    x, offset, mask, weight, bias = (t.double().numpy() for t in (x, offset, mask, weight, bias))
    B, C, Hh, Ww = x.shape
    cg = C // dg
    out = np.repeat(bias[None, :, None, None], B, 0) * np.ones((1, 1, Hh, Ww))

    def at(b, c, y, xx):
        return x[b, c, y, xx] if 0 <= y < Hh and 0 <= xx < Ww else 0.0

    for b in range(B):
        for y in range(Hh):
            for xx in range(Ww):
                for c in range(C):
                    g = c // cg
                    for k in range(9):
                        ky, kx = divmod(k, 3)
                        sy = y + ky - 1 + offset[b, 2 * (g * 9 + k), y, xx]
                        sx = xx + kx - 1 + offset[b, 2 * (g * 9 + k) + 1, y, xx]
                        y0, x0 = int(np.floor(sy)), int(np.floor(sx))
                        fy, fx = sy - y0, sx - x0
                        v = ((1 - fy) * (1 - fx) * at(b, c, y0, x0) + (1 - fy) * fx * at(b, c, y0, x0 + 1)
                             + fy * (1 - fx) * at(b, c, y0 + 1, x0) + fy * fx * at(b, c, y0 + 1, x0 + 1))
                        out[b, :, y, xx] += weight[:, c, ky, kx] * mask[b, g * 9 + k, y, xx] * v
    return torch.from_numpy(out)


def test_plain_dcn_matches_a_loop(monkeypatch):
    """The reference's DCN (bilinear samples laid out 3 x 3 a pixel, one
    strided contraction, in row blocks of one row here) against its
    definition and against the port's plain DCN, offsets up to ~4 px so
    that taps fall outside the frame."""
    g = torch.Generator().manual_seed(3)
    c, cout, dg, h, w = 16, 8, 8, 5, 6
    dcn = R.DCNv2Pack(c, cout, dg)
    with torch.no_grad():
        for p in dcn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x, feat = torch.randn(2, c, h, w, generator=g), torch.randn(2, c, h, w, generator=g)
    out = dcn.conv_offset(feat)
    offset, mask = out[:, : 2 * dg * 9].detach(), torch.sigmoid(out[:, 2 * dg * 9 :]).detach()
    assert offset.abs().max() > 2
    monkeypatch.setattr(R, "SAMPLED_VALUES", 1)  # one row a block
    with torch.no_grad():
        got = dcn(x, feat)
        port = deformConv2dPlain(x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1),
                                 dcn.weight, dcn.bias, dg).permute(0, 3, 1, 2)
    want = _loopDcn(x, offset, mask, dcn.weight.detach(), dcn.bias.detach(), dg)
    _close(got.double(), want, 1e-5)
    _close(port.double(), want, 1e-5)
