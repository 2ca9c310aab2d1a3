"""The port's video path (moephoto_tpu_torch/video/engine.py, the
``buffer`` and video ``output`` steps, ``cli video``) against the JAX
package's: the same ffmpeg command lines and frame bookkeeping, bit-equal
raw frame conversions, the ``VSR`` step's window, geometry and progress
nodes, and whole ``cli video`` slomo and VSR runs through the
repository's fake ffmpeg (``tools/fakeffmpeg.py``) on the CPU."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.utils import imageio as jaxImageio
from moephoto_tpu.video import engine as jaxEngine
from moephoto_tpu_torch import cli
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models.estrnn import modelPaths as estrnnPaths
from moephoto_tpu_torch.models.iconvsr import modelPath_ as vsrPath
from moephoto_tpu_torch.synth import synthESTRNNParams, synthIconVSRParams, synthIFRNetParams
from moephoto_tpu_torch.utils import imageio
from moephoto_tpu_torch.video import engine
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOMO = {"op": "slomo", "model": "IFRNet S", "sf": 2}
VSR = {"op": "VSR"}
DEMOB = {"op": "demob", "model": "1ms8ms"}


@pytest.fixture
def video(tmp_path, monkeypatch):
    """Synthetic IFRNet-S, IconVSR (2-block trunks) and ESTRNN checkpoints in
    a modelDir both packages read, an executable fake ffmpeg, the port on the
    CPU; configs restored after."""
    (tmp_path / "IFRNet").mkdir()
    torch.save(synthIFRNetParams("S", 3), str(tmp_path / "IFRNet" / "IFRNet_S_GoPro.pth"))
    (tmp_path / "vsr").mkdir()
    torch.save(synthIconVSRParams(3, 2), str(tmp_path / vsrPath[len("model/"):]))
    (tmp_path / "ESTRNN").mkdir()
    torch.save(synthESTRNNParams(3), str(tmp_path / estrnnPaths["1ms8ms"][len("model/"):]))
    ff = tmp_path / "ffmpeg"
    ff.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.join(ROOT, "tools", "fakeffmpeg.py")}" "$@"\n')
    ff.chmod(0o755)
    for cfg in (config, jaxConfig):
        monkeypatch.setattr(cfg, "modelDir", str(tmp_path))
        monkeypatch.setattr(cfg, "ffmpegPath", str(ff))
        monkeypatch.setattr(cfg, "opsPath", str(tmp_path / "ops.json"))
    monkeypatch.setattr(config, "device", "cpu")
    return tmp_path


def _chain(start, out, *steps):
    return [{"op": "decode"}, {"op": "range", "start": start}, *[dict(s) for s in steps or (SLOMO,)],
            {"op": "output", "file": str(out), "frameRate": 10}]


@pytest.mark.parametrize("start", [0, 3])
def test_commands_and_bookkeeping_match_jax(video, start):
    """prepare (reference frames for a mid-video start, output trimming)
    and planCommands (geometry, frame rate, audio strategy) as JAX's."""
    out = video / "out.mkv"
    for by, videoOnly in ((True, False), ("", False), ("cmd", True)):
        got = engine.prepare("in.mkv", by, _chain(start, out))
        ref = jaxEngine.prepare("in.mkv", by, _chain(start, out))
        keys = ("outputPath", "start", "stop", "refs", "by", "video", "decodec", "encodec", "width", "height",
                "frameRate")
        assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
        slomo, jaxSlomo = got["slomos"][0]["opt"], ref["slomos"][0]["opt"]
        for attr in ("start", "end", "outStart", "outEnd"):
            assert getattr(slomo, attr) == getattr(jaxSlomo, attr), attr
        assert got["root"].total == ref["root"].total
        cmds = engine.planCommands(got, 64, 48, 10.0, 20, videoOnly)
        assert cmds == jaxEngine.planCommands(ref, 64, 48, 10.0, 20, videoOnly)
        assert got["root"].total == ref["root"].total
    assert "20.0" in cmds[1] and "64x48" in cmds[1]  # sf 2 doubles the frame rate


def test_frame_buffers_are_bit_equal_to_jax():
    """bgr48le bytes -> float frame (u16 / 65536 exactly, values up to
    65535 included) -> 16-bit output bytes, as the JAX package's codec."""
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 65536, (30, 44, 3)).astype(np.uint16)
    raw[0, 0] = (0, 65535, 32768)
    buf = raw.tobytes()
    got = imageio.fromBuffer(buf, 30, 44, device=torch.device("cpu"))
    ref = jaxImageio.fromBuffer(buf, 30, 44)
    assert got.dtype == torch.float32 and got.shape == (30, 44, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), raw / 65536.0)
    x = got.numpy() * 1.01  # past 1 to exercise the clip
    assert imageio.toBuffer(imageio.toOutput(x, 16)) == jaxImageio.toBuffer(jaxImageio.toOutput(x, 16))
    assert imageio.fromBuffer(b"", 30, 44) is None and imageio.toBuffer(None) is None


def test_cli_video_slomo_through_fake_ffmpeg(video, monkeypatch):
    """6 frames of 64x48 through decode -> buffer -> IFRNet-S slomo x2 ->
    output -> encode: 11 frames of 64x48x6 bytes reach the encoder."""
    monkeypatch.setenv("FAKEFF_FRAMES", "6")
    monkeypatch.setenv("FAKEFF_SIZE", "64x48")
    out = video / "out.mkv"
    path, frames = cli.runVideo(str(video / "in.mkv"), str(out), [dict(SLOMO)])
    assert (path, frames) == (str(out), 6)
    with open(path) as fp:
        meta = json.load(fp)
    assert meta == {"bytes": 11 * 64 * 48 * 6, "s": "64x48"}


def test_unported_temporal_ops_raise(video):
    """Every temporal op is ported: ``demob``, which raised until ESTRNN was
    ported, builds, and its window (2 frames back, 2 ahead) is JAX's."""
    from moephoto_tpu_torch.pipeline.steps import genProcess

    process, nodes = genProcess([{"op": "buffer", "bitDepth": 16}, dict(DEMOB), {"op": "output"}])
    assert callable(process) and nodes
    assert engine.lookbackOf("demob") == engine.lookaheadOf("demob") == 2
    assert engine._temporalWindow("demob") == jaxEngine._temporalWindow("demob") == (2, 2)


def test_vsr_window_matches_jax():
    assert engine._temporalWindow("VSR") == jaxEngine._temporalWindow("VSR") == (3, 3)


@pytest.mark.parametrize("start", [0, 2, 5])
def test_vsr_bookkeeping_and_geometry_match_jax(video, start):
    """prepare's reflection padding for the VSR step (a start before its 3
    reference frames pads the rest) and planCommands' x4 geometry, alone
    and after slomo, as JAX's."""
    out = video / "out.mkv"
    for steps in ((VSR,), (SLOMO, VSR)):
        got = engine.prepare("in.mkv", "", _chain(start, out, *steps))
        ref = jaxEngine.prepare("in.mkv", "", _chain(start, out, *steps))
        assert {k: got[k] for k in ("start", "stop", "refs")} == {k: ref[k] for k in ("start", "stop", "refs")}
        vsr, jaxVsr = got["sizes"][0]["opt"], ref["sizes"][0]["opt"]
        for attr in ("start", "end", "outStart", "outEnd"):
            assert getattr(vsr, attr) == getattr(jaxVsr, attr), attr
        cmds = engine.planCommands(got, 64, 48, 10.0, 20, True)
        assert cmds == jaxEngine.planCommands(ref, 64, 48, 10.0, 20, True)
        assert "256x192" in cmds[1]


def test_vsr_gen_process_matches_jax(video):
    """genProcess with a VSR step: the same progress nodes (ops, loads,
    totals) and the x16 load after it, as JAX's."""
    from moephoto_tpu.pipeline.steps import genProcess as jaxGenProcess
    from moephoto_tpu_torch.pipeline.steps import genProcess

    steps = lambda: [{"op": "buffer", "bitDepth": 16}, dict(VSR), {"op": "output"}]
    flat = lambda nodes: [(n.op, n.load, n.total, flat(n.nodes)) for n in nodes]
    _, nodes = genProcess(steps())
    _, jaxNodes = jaxGenProcess(steps())
    assert flat(nodes) == flat(jaxNodes)
    assert any(n.load == 16 for n in nodes[-1].nodes)


def test_cli_video_vsr_through_fake_ffmpeg(video, monkeypatch):
    """8 frames of 64x48 through decode -> buffer -> IconVSR x4 -> output
    -> encode: 8 frames of 256x192x6 bytes reach the encoder."""
    monkeypatch.setenv("FAKEFF_FRAMES", "8")
    monkeypatch.setenv("FAKEFF_SIZE", "64x48")
    out = video / "out.mkv"
    path, frames = cli.runVideo(str(video / "in.mkv"), str(out), [dict(VSR)])
    assert (path, frames) == (str(out), 8)
    with open(path) as fp:
        meta = json.load(fp)
    assert meta == {"bytes": 8 * 256 * 192 * 6, "s": "256x192"}
