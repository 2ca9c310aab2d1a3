"""The port's NAFNet (moephoto_tpu_torch/models/nafnet.py ``NAFBlock``,
``NAFNet``; models/api.py ``LayerNorm2d``) against the JAX package's
(``_nafBlock``, ``makeNAFNet``, ``layerNorm2d``).

One synthetic state dict goes to both: to the port as it is
(``load_state_dict(strict=True)``), to JAX through ``convertStateDict``; JAX
runs in fp32 at precision ``highest``.  The draws put ``beta``/``gamma`` in
[0.1, 1] and the norm weights around 1, so no block is the identity.

Tolerances: the modules and the whole model 2e-5 * max(1, |ref|) (the
summation order of up to ~40 layers); the tiled model 5e-5 absolute, as the
other tiled comparisons; LayerNorm2d 1e-5 absolute in fp32, and in bf16 one
bf16 ulp (2^-7 relative) of JAX's bf16 result.
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.engine.executor import ModelExec as JaxModelExec
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import nafnet as jaxNafnet
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import synth
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import nafnet
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

MODEL_TOL = 2e-5
TILED_TOL = 5e-5
REDUCED = (8, 2, (1, 2), (2, 1))  # width, middle blocks, encoder and decoder counts (tests/test_models_parity.py)


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


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _normSd(rng, c, key="n"):
    return {f"{key}.weight": torch.from_numpy((1 + 0.3 * rng.randn(c)).astype(np.float32)),
            f"{key}.bias": torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))}


def test_layer_norm_2d_matches_jax():
    """Over the channels, biased variance, on values far from 0 (a large
    mean is where a one-pass variance loses digits)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    x = (3.0 + rng.randn(2, 9, 11, 12)).astype(np.float32)
    sd = _normSd(rng, 12)
    norm = PA.LayerNorm2d(12)
    norm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = norm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(JA.layerNorm2d(_jaxParams(sd), "n", jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_layer_norm_2d_normalises_bf16_in_fp32():
    """A bf16 input comes back in bf16 within one bf16 ulp of JAX's, which
    normalises in fp32 and rounds once."""
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    x = (3.0 + rng.randn(1, 7, 5, 16)).astype(np.float32)
    sd = _normSd(rng, 16)
    norm = PA.LayerNorm2d(16)
    norm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.inference_mode():
        got = norm.to(torch.bfloat16)(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    jp = {k: v.astype(jnp.bfloat16) for k, v in _jaxParams(sd).items()}
    ref = np.asarray(JA.layerNorm2d(jp, "n", jnp.asarray(xb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref)
    assert np.all(err <= 2.0 ** -7 * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_nafblock_matches_jax():
    import jax.numpy as jnp

    block = nafnet.NAFBlock(8)
    sd = synth._synthByKind(block, 2, 1.0)
    block.load_state_dict(sd, strict=True)
    x = np.random.RandomState(3).randn(2, 12, 10, 8).astype(np.float32)
    with torch.inference_mode():
        got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jaxNafnet._nafBlock(_jaxParams({"b." + k: v for k, v in sd.items()}), "b", jnp.asarray(x)))
    _assertClose(got, ref)
    assert np.abs(got - x).mean() > 0.1  # both branches add something


def test_nafnet_matches_jax():
    import jax.numpy as jnp

    sd = synth.synthNAFNetParams(*REDUCED, seed=4)
    model = nafnet.NAFNet(*REDUCED)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(5).rand(1, 32, 48, 3).astype(np.float32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1])(_jaxParams(sd), jnp.asarray(x)))
    _assertClose(got, ref)
    assert np.abs(got - x).std() > 0.05


def test_nafnet_through_model_exec_matches_jax():
    """The ``NAFNet_32`` entry's tile spec (256 px, pad 16, align 16) on a
    272x300 image: 2x2 tiles and blended seams in both packages."""
    import jax.numpy as jnp

    sd = synth.synthNAFNetParams(*REDUCED, seed=6)
    model = nafnet.NAFNet(*REDUCED)
    model.load_state_dict(sd, strict=True)
    spec = registry.DN_REGISTRY["NAFNet_32"]["spec"]
    x = np.random.RandomState(7).rand(272, 300, 3).astype(np.float32)
    got = ModelExec(model.eval(), spec, dtype=torch.float32, device="cpu")(torch.from_numpy(x)).numpy()
    jspec = jaxRegistry.DN_REGISTRY["NAFNet_32"]["spec"]
    ref = np.asarray(JaxModelExec(jaxNafnet.makeNAFNet(8, 2, [1, 2], [2, 1]), _jaxParams(sd), jspec,
                                  dtype=jnp.float32)(x))
    assert got.shape == ref.shape == (272, 300, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


@pytest.mark.parametrize("fn,width,middle,enc,dec", [("nafNetSIDD32", 32, 12, (2, 2, 4, 8), (2, 2, 2, 2)),
                                                     ("nafNetGoPro64", 64, 1, (1, 1, 1, 28), (1, 1, 1, 1))])
def test_registry_configurations_have_the_published_layout(fn, width, middle, enc, dec):
    """The nested ``layers.{i}`` keys at the published widths: blocks at
    width << i, ``down`` 2x2 stride 2, ``up.0`` a bias-free 1x1 to twice
    the inner width, the middle stack under ``layers.4``."""
    sd = getattr(nafnet, fn)().state_dict()
    assert sd["intro.weight"].shape == (width, 3, 3, 3) and sd["ending.weight"].shape == (3, width, 3, 3)
    for i in range(4):
        c = width << i
        assert sd[f"layers.{i}.down.weight"].shape == (2 * c, c, 2, 2)
        assert sd[f"layers.{i}.up.0.weight"].shape == (4 * c, 2 * c, 1, 1) and f"layers.{i}.up.0.bias" not in sd
        assert f"layers.{i}.encoder.{enc[i] - 1}.beta" in sd and f"layers.{i}.encoder.{enc[i]}.beta" not in sd
        assert f"layers.{i}.decoder.{dec[3 - i] - 1}.gamma" in sd and f"layers.{i}.decoder.{dec[3 - i]}.gamma" not in sd
    c = width << 4
    assert f"layers.4.{middle - 1}.conv1.weight" in sd and f"layers.4.{middle}.conv1.weight" not in sd
    assert sd["layers.4.0.conv2.weight"].shape == (2 * c, 1, 3, 3)  # depthwise
    assert sd["layers.4.0.sca.1.weight"].shape == (c, c, 1, 1) and sd["layers.4.0.beta"].shape == (1, c, 1, 1)
    assert sd["layers.4.0.conv5.weight"].shape == (c, c, 1, 1) and sd["layers.4.0.norm2.bias"].shape == (c,)


def test_synth_draws_no_identity_block_and_loads_strictly():
    sd = synth.synthNAFNetParams(*REDUCED, seed=0)
    betas = torch.cat([v.flatten() for k, v in sd.items() if k.endswith((".beta", ".gamma"))])
    assert float(betas.min()) >= 0.1 and float(betas.max()) <= 1.0
    norms = torch.cat([v for k, v in sd.items() if ".norm" in k and k.endswith(".weight")])
    assert abs(float(norms.mean()) - 1.0) < 0.1
    model = nafnet.NAFNet(*REDUCED)
    with pytest.raises(RuntimeError):
        model.load_state_dict({k: v for k, v in sd.items() if k != "layers.0.encoder.0.beta"}, strict=True)
