"""The port's dehaze step (moephoto_tpu_torch/pipeline/registry.py
getDehaze, steps.py procDehaze) against the JAX package's, on the retouch
chain sun demoire -> AOD dehaze -> AiLUT, with one synthetic checkpoint
per model in a temporary modelDir that both packages read.

Tolerances: tiled outputs 5e-5 absolute in fp32 (sun's seventeen
conv layers, then the overlap-add blend; order-1 values); CLI pixels
within 1 LSB (the fp32 results differ by ~1e-5 and may round apart)."""

import numpy as np
import pytest
import torch
from PIL import Image

from moephoto_tpu import cli as jaxCli
from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import cli
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.synth import synthAiLUTParams, synthAODParams, synthSunParams

CHAIN = [{"op": "dehaze", "model": "sun"}, {"op": "dehaze", "model": "dehaze"},
         {"op": "dehaze", "model": "AiLUT_sRGB_3"}]
TILED_TOL = 5e-5


@pytest.fixture
def models(tmp_path):
    """Synthetic sun, AOD and AiLUT checkpoints in a temporary modelDir
    seen by both packages; caches cleared and configs restored after."""
    for sub, name, sd in (("demoire", "sun_epoch_200.pth", synthSunParams(21)),
                          ("dehaze", "AOD_net_epoch_relu_10.pth", synthAODParams(22)),
                          ("AiLUT", "AiLUT-FiveK-sRGB.pth", synthAiLUTParams("tpami", 3, 23))):
        (tmp_path / sub).mkdir(exist_ok=True)
        torch.save(sd, str(tmp_path / sub / name))
    saved = (config.device, config.modelDir, config.tileSize, jaxConfig.modelDir, jaxConfig.tileSize)
    caches = (registry._modelCache, registry._paramsCache,
              jaxRegistry._modelCache, jaxRegistry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir, jaxConfig.modelDir = "cpu", str(tmp_path), str(tmp_path)
    yield tmp_path
    config.device, config.modelDir, config.tileSize, jaxConfig.modelDir, jaxConfig.tileSize = saved
    for c in caches:
        c.clear()


def _image(seed, h, w, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


@pytest.mark.parametrize("model", ["sun", "dehaze"])
def test_tiled_dehaze_matches_jax(models, model):
    """64 px tiles on a 70x96 image: several tiles and blended seams in
    both packages."""
    config.tileSize = jaxConfig.tileSize = 64
    x = _image(1, 70, 96)
    got = registry.getDehaze({"model": model})(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxRegistry.getDehaze({"model": model})(x))
    assert got.shape == ref.shape == (70, 96, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


def test_strength_blends_and_keys_the_cache(models):
    x = _image(2, 40, 48)
    half = registry.getDehaze({"model": "dehaze", "strength": 0.6})
    full = registry.getDehaze({"model": "dehaze"})
    assert half is not full and half.strength == 0.6
    assert registry.getDehaze({"model": "dehaze", "strength": 0.6}) is half
    got = half(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxRegistry.getDehaze({"model": "dehaze", "strength": 0.6})(x))
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)
    np.testing.assert_allclose(got, 0.6 * full(torch.from_numpy(x)).numpy() + 0.4 * x, atol=1e-6, rtol=0)


def test_ailut_entry_runs_whole_in_fp32(models, monkeypatch):
    """With the card's bf16 policy in force, sun builds in bf16 and the
    AiLUT entry in fp32, whole."""
    monkeypatch.setattr(config, "dtype", lambda: torch.bfloat16)
    ex = registry.getDehaze({"model": "AiLUT_sRGB_3"})
    assert ex.noTile and ex.dtype == torch.float32
    assert next(ex.model.parameters()).dtype == torch.float32
    sun = registry.getDehaze({"model": "sun"})
    assert not sun.noTile and sun.dtype == torch.bfloat16


def test_cli_retouch_chain_matches_jax(models):
    src = str(models / "in.png")
    rgb = np.random.RandomState(3).randint(0, 256, (52, 70, 3), np.uint8)
    Image.fromarray(rgb).save(src)
    cli.runImage(src, str(models / "port.png"), CHAIN)
    jaxCli.runImage(src, str(models / "jax.png"), CHAIN)
    got = np.asarray(Image.open(models / "port.png")).astype(np.int32)
    ref = np.asarray(Image.open(models / "jax.png")).astype(np.int32)
    assert got.shape == ref.shape == (52, 70, 3)
    assert np.abs(got - ref).max() <= 1


def test_rgba_alpha_passes_around_whole_image_model(models):
    """JAX hands AiLUT all four channels of an RGBA image and its backbone
    raises; the port retouches the RGB channels and keeps the alpha."""
    steps = [{"op": "dehaze", "model": "AiLUT_sRGB_3"}]
    rgba = np.random.RandomState(4).randint(0, 256, (30, 36, 4), np.uint8)
    src, srcRgb = str(models / "rgba.png"), str(models / "rgb.png")
    Image.fromarray(rgba, "RGBA").save(src)
    Image.fromarray(rgba[..., :3]).save(srcRgb)
    with pytest.raises(ValueError):
        jaxCli.runImage(src, str(models / "jax.png"), steps)
    cli.runImage(src, str(models / "port.png"), steps)
    cli.runImage(srcRgb, str(models / "port_rgb.png"), steps)
    got = np.asarray(Image.open(models / "port.png"))
    assert got.shape == (30, 36, 4)
    np.testing.assert_array_equal(got[..., 3], rgba[..., 3])
    np.testing.assert_array_equal(got[..., :3], np.asarray(Image.open(models / "port_rgb.png")))


def test_unported_dehaze_model_raises(models):
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.getDehaze({"model": "NAFNet_deblur_32"})
    from moephoto_tpu_torch.pipeline.steps import genProcess

    with pytest.raises(NotImplementedError, match="not ported"):
        genProcess([{"op": "file"}, {"op": "dehaze", "model": "NAFNet_deblur_32"}, {"op": "output"}])
