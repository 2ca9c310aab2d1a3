"""The port's step pipeline and CLI (moephoto_tpu_torch/cli.py,
pipeline/, progress.py) against the JAX package's, end to end on a PNG,
and its device policy."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from moephoto_tpu import cli as jaxCli
from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import cli, progress
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.synth import synthLite2Params
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [{"op": "SR", "model": "lite", "scale": 4}]


@pytest.fixture
def models(tmp_path):
    """One synth lite x4 checkpoint in a temporary modelDir, seen by both
    packages; caches cleared and configs restored afterwards."""
    (tmp_path / "lite").mkdir()
    torch.save(synthLite2Params(4, seed=11), str(tmp_path / "lite" / "model_4.pth"))
    saved = (config.device, config.modelDir, jaxConfig.modelDir)
    caches = (registry._modelCache, registry._paramsCache,
              jaxRegistry._modelCache, jaxRegistry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir, jaxConfig.modelDir = "cpu", str(tmp_path), str(tmp_path)
    yield tmp_path
    config.device, config.modelDir, jaxConfig.modelDir = saved
    for c in caches:
        c.clear()


def test_cli_image_sr_matches_jax(models):
    """Same PNG, same weights: output pixels within 1 LSB (the two
    packages' fp32 results differ by ~1e-5 and may round apart)."""
    src = str(models / "in.png")
    rgb = np.random.RandomState(0).randint(0, 256, (30, 41, 3), np.uint8)
    Image.fromarray(rgb).save(src)
    cli.runImage(src, str(models / "port.png"), STEPS)
    jaxCli.runImage(src, str(models / "jax.png"), STEPS)
    got = np.asarray(Image.open(models / "port.png")).astype(np.int32)
    ref = np.asarray(Image.open(models / "jax.png")).astype(np.int32)
    assert got.shape == ref.shape == (120, 164, 3)
    assert np.abs(got - ref).max() <= 1


def test_run_image_sets_a_fresh_stop_flag(models):
    """As the JAX package's runImage: every image task starts with a stop
    flag of its own that is not set, whatever the last task left behind."""
    from moephoto_tpu.runtime.context import context as jaxContext
    from moephoto_tpu_torch.runtime.context import context

    src = str(models / "in.png")
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (9, 11, 3), np.uint8)).save(src)
    context.stopFlag = None
    cli.runImage(src, str(models / "a.png"), STEPS)
    first = context.stopFlag
    assert first is not None and first.is_set() is False
    first.set()  # a task that was stopped
    cli.runImage(src, str(models / "b.png"), STEPS)
    assert context.stopFlag is not first and context.stopFlag.is_set() is False
    jaxContext.stopFlag = None
    jaxCli.runImage(src, str(models / "jax.png"), STEPS)
    assert jaxContext.stopFlag is not None and jaxContext.stopFlag.is_set() is False


def test_entry_points_raise_without_gpu(models):
    """With the default device and no GPU the port raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.getSR({"model": "lite", "scale": 4})
    src = str(models / "in.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.runImage(src, str(models / "out.png"), STEPS)


def test_zoo_models_and_demob_run_through_the_pipeline(models, monkeypatch):
    """``DN NAFNet_32``, ``SR gan x4`` and ``dehaze NAFNet_deblur_32``, which
    raised until they were ported, run through ``cli image`` on tiny
    synthesised checkpoints (both packages' constructors set to the same
    reduced widths) within 1 LSB of the JAX CLI; ``demob``, which raised
    until ESTRNN was ported, runs through ``cli video`` (the fake ffmpeg, 6
    frames in and out)."""
    from moephoto_tpu.models import nafnet as jaxNafnet
    from moephoto_tpu.models import restore as jaxRestore
    from moephoto_tpu_torch.models import nafnet, restore
    from moephoto_tpu_torch.models.estrnn import modelPaths
    from moephoto_tpu_torch.synth import synthESTRNNParams, synthNAFNetParams, synthRRDBParams

    naf = (8, 2, (1, 2), (2, 1))
    (models / "NAFNet").mkdir()
    (models / "gan").mkdir()
    torch.save(synthNAFNetParams(*naf, seed=12), str(models / "NAFNet" / "NAFNet-SIDD-width32.pth"))
    torch.save(synthNAFNetParams(*naf, seed=13), str(models / "NAFNet" / "NAFNet-GoPro-width32.pth"))
    torch.save(synthRRDBParams(4, 2, seed=14), str(models / "gan" / "RealESRGAN_x4plus.pth"))
    for mod, fn, make in ((nafnet, "nafNetSIDD32", lambda: nafnet.NAFNet(*naf)),
                          (nafnet, "nafNetGoPro32", lambda: nafnet.NAFNet(*naf)),
                          (restore, "rrdbNetX4", lambda: restore.RRDBNet(4, 2)),
                          (jaxNafnet, "nafNetSIDD32", jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1])),
                          (jaxNafnet, "nafNetGoPro32", jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1])),
                          (jaxRestore, "rrdbNetX4", jaxRestore.makeRRDBNet(4, 2))):
        monkeypatch.setattr(mod, fn, make)
    src = str(models / "in.png")
    Image.fromarray(np.random.RandomState(2).randint(0, 256, (24, 20, 3), np.uint8)).save(src)
    for step, shape in (({"op": "DN", "model": "NAFNet_32"}, (24, 20, 3)),
                        ({"op": "SR", "model": "gan", "scale": 4}, (96, 80, 3)),
                        ({"op": "dehaze", "model": "NAFNet_deblur_32"}, (24, 20, 3))):
        cli.runImage(src, str(models / "port.png"), [dict(step)])
        jaxCli.runImage(src, str(models / "jax.png"), [dict(step)])
        got = np.asarray(Image.open(models / "port.png")).astype(np.int32)
        ref = np.asarray(Image.open(models / "jax.png")).astype(np.int32)
        assert got.shape == ref.shape == shape and np.abs(got - ref).max() <= 1 and got.std() > 1, step
    (models / "ESTRNN").mkdir()
    torch.save(synthESTRNNParams(0), str(models / modelPaths["1ms8ms"][len("model/"):]))
    ff = models / "ffmpeg"
    ff.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.join(ROOT, "tools", "fakeffmpeg.py")}" "$@"\n')
    ff.chmod(0o755)
    monkeypatch.setattr(config, "ffmpegPath", str(ff))
    monkeypatch.setattr(config, "opsPath", str(models / "ops.json"))
    monkeypatch.setenv("FAKEFF_FRAMES", "6")
    monkeypatch.setenv("FAKEFF_SIZE", "32x24")
    out = models / "out.mkv"
    cli.main(["video", str(models / "in.mkv"), str(out), "--steps", '[{"op": "demob", "model": "1ms8ms"}]'])
    with open(out) as fp:
        assert json.load(fp) == {"bytes": 6 * 32 * 24 * 6, "s": "32x24"}


def test_node_waits_for_device_result_before_timing(monkeypatch):
    """A step's node learns its own device time: bindFunc synchronises on
    a result that lives off the CPU before it traces, and not on a CPU
    result."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    node = progress.Node({"op": "SR", "model": "t"})
    out = node.bindFunc(lambda: torch.empty(2, device="meta"))()
    assert out.device.type == "meta" and len(calls) == 1
    progress.Node({"op": "toFloat"}).bindFunc(lambda: torch.zeros(2))()
    assert len(calls) == 1
