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
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

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


def test_zoo_dehaze_models_run_through_the_dehaze_step(models, monkeypatch):
    """``NAFNet_deblur_32`` and ``MPRNet_deraining``, which raised until they
    were ported, build through ``getDehaze`` with the JAX entries' tile
    specs and run on tiny synthesised checkpoints (both packages'
    constructors set to the same reduced widths) within the tiled tolerance
    of the JAX executors; ``genProcess`` compiles the step."""
    from moephoto_tpu.models import mprnet as jaxMprnet
    from moephoto_tpu.models import nafnet as jaxNafnet
    from moephoto_tpu_torch import progress
    from moephoto_tpu_torch.models import mprnet, nafnet
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.synth import synthMPRNetParams, synthNAFNetParams

    (models / "NAFNet").mkdir()
    (models / "MPRNet").mkdir()
    torch.save(synthNAFNetParams(8, 2, (1, 2), (2, 1), seed=24), str(models / "NAFNet" / "NAFNet-GoPro-width32.pth"))
    torch.save(synthMPRNetParams(16, 8, 8, 2, seed=25), str(models / "MPRNet" / "model_deraining.pth"))
    monkeypatch.setattr(nafnet, "nafNetGoPro32", lambda: nafnet.NAFNet(8, 2, (1, 2), (2, 1)))
    monkeypatch.setattr(mprnet, "mprNetDerain", lambda: mprnet.MPRNet(16, 8, 8, 2))
    monkeypatch.setattr(jaxNafnet, "nafNetGoPro32", jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1]))
    monkeypatch.setattr(jaxMprnet, "mprNetDerain", jaxMprnet.makeMPRNet(16, 8, 8, 2))
    x = _image(5, 40, 48)
    for model in ("NAFNet_deblur_32", "MPRNet_deraining"):
        ex = registry.getDehaze({"model": model})
        assert ex.spec == registry.DEHAZE_REGISTRY[model]["spec"] and not ex.noTile
        got = ex(torch.from_numpy(x)).numpy()
        ref = np.asarray(jaxRegistry.getDehaze({"model": model})(x))
        assert got.shape == ref.shape == (40, 48, 3)
        np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)
        _, nodes = genProcess([{"op": "file"}, {"op": "dehaze", "model": model}, {"op": "output"}])
        assert [progress._registry[n.op].op.get("op") for n in nodes].count(model) == 1
