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


def test_unported_ops_raise(models, monkeypatch):
    """The models the port lacks raise by name; ``demob``, which raised
    until ESTRNN was ported, runs through ``cli video`` (the fake ffmpeg, 6
    frames in and out)."""
    from moephoto_tpu_torch.models.estrnn import modelPaths
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.synth import synthESTRNNParams

    with pytest.raises(NotImplementedError, match="not ported"):
        genProcess([{"op": "file"}, {"op": "DN", "model": "NAFNet_32"}, {"op": "output"}])
    with pytest.raises(NotImplementedError, match="not ported"):
        genProcess([{"op": "file"}, {"op": "SR", "model": "gan", "scale": 4}, {"op": "output"}])
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
