"""The port's step pipeline and CLI (moephoto_tpu_torch/cli.py,
pipeline/, progress.py) against the JAX package's, end to end on a PNG,
and its device policy."""

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


def test_unported_ops_raise(models):
    from moephoto_tpu_torch.pipeline.steps import genProcess

    with pytest.raises(NotImplementedError, match="not ported"):
        genProcess([{"op": "file"}, {"op": "DN", "model": "NAFNet_32"}, {"op": "output"}])
    with pytest.raises(NotImplementedError, match="not ported"):
        genProcess([{"op": "file"}, {"op": "SR", "model": "gan", "scale": 4}, {"op": "output"}])
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["video", "in.mkv", "out.mkv", "--steps", '[{"op": "demob"}]'])


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
