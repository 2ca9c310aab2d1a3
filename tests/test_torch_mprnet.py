"""The port's MPRNet (moephoto_tpu_torch/models/mprnet.py ``CAB``, ``SAM``,
``MPRNet``), its ``interpolateScale`` (models/api.py), and BASELINE config 3
(``cli image`` DN MPRNet_denoising -> DN NAFNet_32) against the JAX
package's.

One synthetic state dict per model goes to both: to the port as it is
(``load_state_dict(strict=True)``), to JAX through ``convertStateDict``; JAX
runs in fp32 at precision ``highest``.  The port runs MPRNet's four
quadrants (and two halves) as one batch where JAX loops over them.

Tolerances: ``interpolateScale`` 1e-6 absolute on values in [0, 1) (one
fp32 weight formula on both sides, another operation order); the modules
and the whole model 2e-5 * max(1, |ref|); the tiled model 5e-5 absolute;
CLI pixels within 1 LSB (fp32 results ~1e-6 apart may round apart).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from moephoto_tpu import cli as jaxCli
from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.engine.executor import ModelExec as JaxModelExec
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import mprnet as jaxMprnet
from moephoto_tpu.models import nafnet as jaxNafnet
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import cli, synth
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import mprnet, nafnet
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

MODEL_TOL = 2e-5
TILED_TOL = 5e-5
REDUCED = (16, 8, 8, 2)  # nFeat, scaleUnetFeats, scaleOrsnetFeats, numCab (tests/test_models_parity.py)
NAF_REDUCED = (8, 2, (1, 2), (2, 1))
CONFIG3 = [{"op": "DN", "model": "MPRNet_denoising"}, {"op": "DN", "model": "NAFNet_32"}]


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


def _nhwc(module, x, *args):
    with torch.inference_mode():
        out = module(torch.from_numpy(x).permute(0, 3, 1, 2), *args)
    return [o.permute(0, 2, 3, 1).numpy() for o in out] if isinstance(out, tuple) else out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("scale,hw", [(0.5, (16, 24)), (0.5, (17, 23)), (2.0, (9, 13)), (2.0, (16, 8))],
                         ids=["half_even", "half_odd", "double_odd", "double_even"])
def test_interpolate_scale_matches_jax(mode, scale, hw):
    """Output size int(H scale); no antialiasing at 0.5x, where an
    antialiased resize would spread each output over four rows."""
    import jax.numpy as jnp

    x = np.random.RandomState(0).rand(2, *hw, 5).astype(np.float32)
    got = PA.interpolateScale(torch.from_numpy(x), scale, mode).numpy()
    ref = np.asarray(JA.interpolateScale(jnp.asarray(x), scale, mode))
    assert got.shape == ref.shape == (2, int(hw[0] * scale), int(hw[1] * scale), 5)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if mode == "bilinear" and hw == (16, 24):
        np.testing.assert_allclose(got, 0.25 * (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, 1::2]),
                                   atol=1e-6, rtol=0)


def _sdOf(module, seed, prefix):
    sd = synth._synthByKind(module, seed, 1.0)
    module.load_state_dict(sd, strict=True)
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def test_cab_matches_jax_and_has_no_bias():
    import jax.numpy as jnp

    cab = mprnet.CAB(16)
    sd = _sdOf(cab, 1, "c")
    assert not any(k.endswith(".bias") for k in sd) and sd["c.3.conv_du.0.weight"].shape == (4, 16, 1, 1)
    x = np.random.RandomState(2).randn(2, 10, 12, 16).astype(np.float32)
    _assertClose(_nhwc(cab, x), np.asarray(jaxMprnet._cab(_jaxParams(sd), "c", jnp.asarray(x), 3)))


def test_sam_matches_jax():
    import jax.numpy as jnp

    sam = mprnet.SAM(16)
    sd = _sdOf(sam, 3, "s")
    rng = np.random.RandomState(4)
    x, img = rng.randn(2, 8, 12, 16).astype(np.float32), rng.rand(2, 8, 12, 3).astype(np.float32)
    got = _nhwc(sam, x, torch.from_numpy(img).permute(0, 3, 1, 2))
    ref = jaxMprnet._sam(_jaxParams(sd), "s", jnp.asarray(x), jnp.asarray(img))
    for g, r in zip(got, ref):
        _assertClose(g, np.asarray(r))


@pytest.mark.parametrize("hw", [(32, 32), (32, 48)])
def test_mprnet_matches_jax(hw):
    """A non-square input tells a join along H from one along W."""
    import jax.numpy as jnp

    sd = synth.synthMPRNetParams(*REDUCED, seed=5)
    model = mprnet.MPRNet(*REDUCED)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(6).rand(1, *hw, 3).astype(np.float32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxMprnet.makeMPRNet(*REDUCED)(_jaxParams(sd), jnp.asarray(x)))
    _assertClose(got, ref)
    assert 0.0 < got.mean() < 1.0 and np.abs(got - x).std() > 0.05


def test_mprnet_rejects_sizes_off_eight():
    with pytest.raises(ValueError, match="% 8"):
        mprnet.MPRNet(*REDUCED)(torch.zeros(1, 36, 32, 3))


def test_mprnet_through_model_exec_matches_jax():
    """The ``MPRNet_denoising`` entry's tile spec (256 px, pad 8, batch 2)
    on a 264x280 image: 2x2 tiles in both packages."""
    import jax.numpy as jnp

    sd = synth.synthMPRNetParams(*REDUCED, seed=7)
    model = mprnet.MPRNet(*REDUCED)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(8).rand(264, 280, 3).astype(np.float32)
    got = ModelExec(model.eval(), registry.DN_REGISTRY["MPRNet_denoising"]["spec"], dtype=torch.float32,
                    device="cpu")(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxModelExec(jaxMprnet.makeMPRNet(*REDUCED), _jaxParams(sd),
                                  jaxRegistry.DN_REGISTRY["MPRNet_denoising"]["spec"], dtype=jnp.float32)(x))
    assert got.shape == ref.shape == (264, 280, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


@pytest.mark.parametrize("fn,n,s,o,params", [("mprNetDenoise", 80, 48, 32, 15741079),
                                             ("mprNet", 96, 48, 32, 20127127), ("mprNetDerain", 40, 20, 16, None)])
def test_registry_configurations_have_the_published_widths(fn, n, s, o, params):
    """Encoder levels n, n + s, n + 2s, ORSNet at n + o, no bias; the
    deblurring and denoising models come to the published 20.1 M and
    15.7 M parameters."""
    sd = getattr(mprnet, fn)().state_dict()
    assert not any(k.endswith(".bias") for k in sd)
    shape = lambda k: tuple(sd[k + ".weight"].shape)
    assert shape("shallow_feat.2.0") == (n, 3, 3, 3) and shape("tail") == (3, n + o, 3, 3)
    assert shape("encoder.0.encoder.2.0.1") == (n + 2 * s, n + s, 1, 1)
    assert shape("encoder.1.csff_dec.2") == (n + 2 * s,) * 2 + (1, 1)
    assert shape("decoder.1.up.1.up.1") == (n + s, n + 2 * s, 1, 1) and shape("decoder.0.skip_attn.1.0") == (n + s,) * 2 + (3, 3)
    assert shape("sam.1.conv2") == (3, n, 1, 1) and shape("concat.0") == (n, 2 * n, 3, 3)
    assert shape("concat.1") == (n + o, 2 * n, 3, 3) and shape("encoder.2.orb.2.8") == (n + o,) * 2 + (3, 3)
    assert shape("encoder.2.conv_enc.2.0.1") == (n + s, n + 2 * s, 1, 1) and shape("encoder.2.conv_dec.2.2") == (n + o, n, 1, 1)
    assert shape("encoder.2.orb.0.7.3.conv_du.0") == ((n + o) // 4, n + o, 1, 1)
    if params:
        assert sum(v.numel() for v in sd.values()) == params


@pytest.fixture
def config3(tmp_path, monkeypatch):
    """BASELINE config 3's two checkpoints at reduced widths in a temporary
    modelDir seen by both packages, each package's registry constructor set
    to the same reduced configuration."""
    (tmp_path / "MPRNet").mkdir()
    (tmp_path / "NAFNet").mkdir()
    torch.save(synth.synthMPRNetParams(*REDUCED, seed=9), str(tmp_path / "MPRNet" / "model_denoising.pth"))
    torch.save(synth.synthNAFNetParams(*NAF_REDUCED, seed=10), str(tmp_path / "NAFNet" / "NAFNet-SIDD-width32.pth"))
    monkeypatch.setattr(mprnet, "mprNetDenoise", lambda: mprnet.MPRNet(*REDUCED))
    monkeypatch.setattr(nafnet, "nafNetSIDD32", lambda: nafnet.NAFNet(*NAF_REDUCED))
    monkeypatch.setattr(jaxMprnet, "mprNetDenoise", jaxMprnet.makeMPRNet(*REDUCED))
    monkeypatch.setattr(jaxNafnet, "nafNetSIDD32", jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1]))
    caches = (registry._modelCache, registry._paramsCache, jaxRegistry._modelCache, jaxRegistry._paramsCache)
    for c in caches:
        c.clear()
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "modelDir", str(tmp_path))
    monkeypatch.setattr(jaxConfig, "modelDir", str(tmp_path))
    yield tmp_path
    for c in caches:
        c.clear()


def test_cli_config3_matches_jax(config3):
    """BASELINE config 3, DN MPRNet_denoising -> DN NAFNet_32, PNG to PNG."""
    src = str(config3 / "in.png")
    Image.fromarray(np.random.RandomState(11).randint(0, 256, (40, 56, 3), np.uint8)).save(src)
    cli.runImage(src, str(config3 / "port.png"), CONFIG3)
    jaxCli.runImage(src, str(config3 / "jax.png"), CONFIG3)
    got = np.asarray(Image.open(config3 / "port.png")).astype(np.int32)
    ref = np.asarray(Image.open(config3 / "jax.png")).astype(np.int32)
    assert got.shape == ref.shape == (40, 56, 3)
    assert np.abs(got - ref).max() <= 1 and got.std() > 1
