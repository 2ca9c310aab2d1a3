"""The port's Real-ESRGAN RRDBNet and RealBasicVSR ImageCleaning
(moephoto_tpu_torch/models/restore.py), its ``pixelUnshuffle``
(models/api.py) and ``CARB`` (models/blocks.py) against the JAX package's
(``makeRRDBNet``, ``imageCleaning``, ``pixelUnshuffle``, ``carb``).

One synthetic state dict per model goes to both: to the port as it is
(``load_state_dict(strict=True)``), to JAX through ``convertStateDict``; JAX
runs in fp32 at precision ``highest``.

Tolerances: ``pixelUnshuffle`` exact (a permutation); the modules and the
whole models 2e-5 * max(1, |ref|); the tiled models 5e-5 absolute, as the
other tiled comparisons.
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.engine.executor import ModelExec as JaxModelExec
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import blocks as jaxBlocks
from moephoto_tpu.models import restore as jaxRestore
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import synth
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import blocks, restore
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

MODEL_TOL = 2e-5
TILED_TOL = 5e-5
RRDB_BLOCKS = 2  # tests/test_models_parity.py's reduced RRDBNet


@pytest.fixture(autouse=True)
def highest():
    JA.setPrecision("highest")


def _jaxParams(sd):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in JA.convertStateDict({k: v.numpy() for k, v in sd.items()}).items()}


def _assertClose(got, ref, tol=MODEL_TOL):
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), float(err.max())


def _image(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_pixel_unshuffle_matches_jax(r):
    """Channel c r^2 + i r + j: ``F.pixel_unshuffle``'s order, exactly."""
    import jax.numpy as jnp

    x = _image(0, 2, 8, 12, 3)
    got = PA.pixelUnshuffle(torch.from_numpy(x), r).numpy()
    ref = np.asarray(JA.pixelUnshuffle(jnp.asarray(x), r))
    assert got.shape == ref.shape == (2, 8 // r, 12 // r, 3 * r * r)
    np.testing.assert_array_equal(got, ref)
    if r == 2:  # output channel 1 * 4 + 1 * 2 + 0: input channel 1 at row offset 1, column offset 0
        np.testing.assert_array_equal(got[..., 6], x[:, 1::2, ::2, 1])


def test_carb_matches_jax_and_its_keys():
    import jax.numpy as jnp

    carb = blocks.CARB(16, 4)
    sd = synth._synthByKind(carb, 1, 1.0)
    carb.load_state_dict(sd, strict=True)
    assert sorted(k for k in sd if k.startswith("1.")) == [
        "1.0.ca.conv_du.0.bias", "1.0.ca.conv_du.0.weight", "1.0.ca.conv_du.2.bias", "1.0.ca.conv_du.2.weight",
        "1.0.conv1.bias", "1.0.conv1.weight", "1.0.conv2.bias", "1.0.conv2.weight", "1.0.relu.weight"]
    x = np.random.RandomState(2).randn(2, 9, 11, 16).astype(np.float32)
    with torch.inference_mode():
        got = carb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jaxBlocks.carb(_jaxParams({"c." + k: v for k, v in sd.items()}), "c", jnp.asarray(x)))
    _assertClose(got, ref)


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_matches_jax(scale):
    """x4 and x2 (the pixel-unshuffle input) with 2 RRDBs at 32x32."""
    import jax.numpy as jnp

    sd = synth.synthRRDBParams(scale, RRDB_BLOCKS, seed=3)
    model = restore.RRDBNet(scale, RRDB_BLOCKS)
    model.load_state_dict(sd, strict=True)
    x = _image(4, 1, 32, 32, 3)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxRestore.makeRRDBNet(scale, RRDB_BLOCKS)(_jaxParams(sd), jnp.asarray(x)))
    assert got.shape == (1, 32 * scale, 32 * scale, 3)
    _assertClose(got, ref)
    assert got.std() > 0.02


def test_image_cleaning_matches_jax():
    """At full width: 64 features, 20 residual blocks, at 32x32."""
    import jax.numpy as jnp

    sd = synth.synthImageCleaningParams(seed=5)
    model = restore.ImageCleaning()
    model.load_state_dict(sd, strict=True)
    x = _image(6, 1, 32, 32, 3)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxRestore.imageCleaning(_jaxParams(sd), jnp.asarray(x)))
    _assertClose(got, ref)
    assert np.abs(got - x).std() > 0.05


@pytest.mark.parametrize("fn,scale,blocks_,params", [("rrdbNetX4", 4, 23, 16697987), ("rrdbNetX2", 2, 23, 16703171),
                                                     ("rrdbNetX4Anime", 4, 6, None)])
def test_rrdb_registry_configurations_have_the_published_widths(fn, scale, blocks_, params):
    """64 features, growth 32, every conv with bias; x4plus has the
    published 16.7 M parameters."""
    sd = getattr(restore, fn)().state_dict()
    assert sd["conv_first.weight"].shape == (64, 3 * (4 // scale) ** 2, 3, 3)
    assert [tuple(sd[f"body.0.rdb3.conv.{i}.weight"].shape[:2]) for i in range(5)] == [
        (32, 64), (32, 96), (32, 128), (32, 160), (64, 192)]
    assert f"body.{blocks_ - 1}.rdb1.conv.0.bias" in sd and f"body.{blocks_}.rdb1.conv.0.bias" not in sd
    assert sd["conv_last.weight"].shape == (3, 64, 3, 3) and sd["conv_hr.bias"].shape == (64,)
    if params:
        assert sum(v.numel() for v in sd.values()) == params


ZOO = {
    "gan4": (lambda: restore.RRDBNet(4, RRDB_BLOCKS), lambda: synth.synthRRDBParams(4, RRDB_BLOCKS, seed=7),
             jaxRestore.makeRRDBNet(4, RRDB_BLOCKS), "SR", (200, 60)),
    "gan2": (lambda: restore.RRDBNet(2, RRDB_BLOCKS), lambda: synth.synthRRDBParams(2, RRDB_BLOCKS, seed=8),
             jaxRestore.makeRRDBNet(2, RRDB_BLOCKS), "SR", (200, 60)),
    "VSR_Cleaning": (restore.ImageCleaning, lambda: synth.synthImageCleaningParams(seed=9), jaxRestore.imageCleaning,
                     "DN", (270, 40)),
}


@pytest.mark.parametrize("key", list(ZOO))
def test_tiled_model_matches_jax(key):
    """Each entry's tile spec (gan: 192 px, pad 8, align 4) on an image two
    tiles high, in both packages."""
    import jax.numpy as jnp

    make, makeSd, jaxFn, kind, hw = ZOO[key]
    sd = makeSd()
    model = make()
    model.load_state_dict(sd, strict=True)
    entry = {"SR": registry.SR_REGISTRY, "DN": registry.DN_REGISTRY}[kind][key]
    jaxEntry = {"SR": jaxRegistry.SR_REGISTRY, "DN": jaxRegistry.DN_REGISTRY}[kind][key]
    x = _image(10, *hw, 3)
    got = ModelExec(model.eval(), entry["spec"], dtype=torch.float32, device="cpu")(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxModelExec(jaxFn, _jaxParams(sd), jaxEntry["spec"], dtype=jnp.float32)(x))
    sc = int(entry["spec"].scale)
    assert got.shape == ref.shape == (hw[0] * sc, hw[1] * sc, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)
