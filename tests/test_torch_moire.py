"""The port's moire_obj and moire_screen_gan (moephoto_tpu_torch/models/
demoire.py ``MoireObj``, ``MoireScreenGan`` and their parts) against the
JAX package's (``moireObj``, ``makeMoireScreenGan``, ``_spaceAttention``,
``_din``, ``_nonlocalCA``).

No source fixes these two models' widths; the port takes one feature width
c, and the tests run c = 16 (moire_obj, 64x64) and c = 8 (moire_screen_gan
at 512x512, the smallest input its style chain allows).  One synthetic
state dict per model goes to both: to the port as it is
(``load_state_dict(strict=True)``), to JAX through ``convertStateDict``; JAX
runs in fp32 at precision ``highest``.

Tolerances: the modules and the whole models 2e-5 * max(1, |ref|) (the
attention products sum over up to 4096 positions); the tiled models 5e-5
absolute, as the other tiled comparisons.
"""

import dataclasses

import numpy as np
import pytest
import torch

from moephoto_tpu.engine.executor import ModelExec as JaxModelExec
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import demoire as jaxDemoire
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu_torch import synth
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.models import demoire
from moephoto_tpu_torch.pipeline import registry
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

MODEL_TOL = 2e-5
TILED_TOL = 5e-5
OBJ_C, GAN_C = 16, 8


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


def _module(module, seed, x, gain=1.0):
    """The module under seeded draws on NHWC ``x``, and its draws."""
    sd = synth._synthByKind(module, seed, gain)
    module.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = module(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return got, _jaxParams({"m." + k: v for k, v in sd.items()})


def test_space_attention_matches_jax():
    """softmax(K Q^T) V with K as the query side and no 1/sqrt(d) scale:
    with K and Q swapped the result moves far beyond the tolerance."""
    import jax.numpy as jnp

    x = np.random.RandomState(0).randn(2, 9, 7, 8).astype(np.float32)
    sa = demoire.SpaceAttention(8)
    got, params = _module(sa, 1, x)
    ref = np.asarray(jaxDemoire._spaceAttention(params, "m", jnp.asarray(x)))
    _assertClose(got, ref)
    swapped = {**params, "m.K.weight": params["m.Q.weight"], "m.Q.weight": params["m.K.weight"],
               "m.K.bias": params["m.Q.bias"], "m.Q.bias": params["m.K.bias"]}
    assert np.abs(np.asarray(jaxDemoire._spaceAttention(swapped, "m", jnp.asarray(x))) - got).max() > 1e-2


def test_attention_rounds_its_weights_once_in_bf16():
    """In bf16 the logits and the softmax are fp32 and only the weights and
    the result round to bf16, as JAX's einsums with an fp32 preferred type:
    within one bf16 ulp of JAX's bf16 run."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 30, 8).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    got = demoire.attend(q, k, v)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    att = jnp.einsum("bnc,bmc->bnm", jq, jk, preferred_element_type=jnp.float32)
    att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
    ref = np.asarray(jnp.einsum("bnm,bmc->bnc", att, jv, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref)
    assert np.all(err <= 2.0 ** -7 * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_din_matches_jax_and_keeps_the_reference_nan():
    """Unbiased std in fp32 with eps 1e-4 on the content's std; a
    one-pixel style map has no unbiased std, NaN in both packages."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    content, style = rng.randn(2, 6, 5, 4).astype(np.float32), (2 + 3 * rng.randn(2, 3, 2, 4)).astype(np.float32)
    got = demoire.din(torch.from_numpy(content).permute(0, 3, 1, 2),
                      torch.from_numpy(style).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _assertClose(got, np.asarray(jaxDemoire._din(jnp.asarray(content), jnp.asarray(style))))
    one = style[:, :1, :1]
    nan = demoire.din(torch.from_numpy(content).permute(0, 3, 1, 2), torch.from_numpy(one).permute(0, 3, 1, 2))
    assert torch.isnan(nan).all() and np.isnan(np.asarray(jaxDemoire._din(jnp.asarray(content), jnp.asarray(one)))).all()


@pytest.mark.parametrize("hw", [(12, 10), (13, 11)], ids=["even", "odd"])
def test_nonlocal_ca_matches_jax(hw):
    """Quarters cut at (h // 2, w // 2): unequal quarters on odd sizes."""
    import jax.numpy as jnp

    x = np.random.RandomState(4).randn(2, *hw, 8).astype(np.float32)
    got, params = _module(demoire.NonLocalCA(8, 4), 5, x)
    _assertClose(got, np.asarray(jaxDemoire._nonlocalCA(params, "m", jnp.asarray(x))))


def test_rk3_matches_jax():
    import jax.numpy as jnp

    x = np.random.RandomState(6).randn(1, 8, 9, 8).astype(np.float32)
    got, params = _module(demoire.RK3(8), 7, x)
    _assertClose(got, np.asarray(jaxDemoire._rk3(params, "m", jnp.asarray(x))))


def test_moire_obj_matches_jax():
    import jax.numpy as jnp

    sd = synth.synthMoireObjParams(OBJ_C, seed=8)
    model = demoire.MoireObj(OBJ_C)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(9).rand(1, 64, 64, 3).astype(np.float32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxDemoire.moireObj(_jaxParams(sd), jnp.asarray(x)))
    _assertClose(got, ref)
    assert got.std() > 0.05


def test_moire_screen_gan_matches_jax():
    import jax.numpy as jnp

    sd = synth.synthMoireScreenGanParams(GAN_C, seed=10)
    model = demoire.MoireScreenGan(GAN_C)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(11).rand(1, 512, 512, 3).astype(np.float32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxDemoire.moireScreenGan(_jaxParams(sd), jnp.asarray(x)))
    _assertClose(got, ref)
    assert got.std() > 0.05


def test_moire_key_layouts_at_the_assumed_width():
    """c = 64: CAT halves 2c -> c, the upsample blocks map c -> 4c, the
    non-local blocks run at c / 2, the style convs carry the branch's
    strides."""
    obj = demoire.MoireObj().state_dict()
    assert obj["U.3.branch2.deepF.0.1.weight"].shape == (64, 128, 1, 1)
    assert obj["U.3.branch2.deepF.0.0.conv_du.0.weight"].shape == (8, 128, 1, 1)
    assert obj["U.3.3.branch3.combineF.u1.0.weight"].shape == (256, 64, 3, 3)
    assert obj["U.3.3.branch3.deepF.9.scale.4.scale"].shape == (1,) and "U.3.3.branch3.deepF.10.ms.0.0.weight" not in obj
    assert obj["U.branch1.inputF.conv_input.weight"].shape == (64, 3, 3, 3) and "U.branch1.combineF.SA2.K.weight" not in obj
    assert obj["U.down2_1.block.1.0.ca.conv_du.2.weight"].shape == (64, 4, 1, 1)
    assert obj["to_clean1.residual.0.se.conv_du.0.weight"].shape == (4, 64, 1, 1)
    gan = demoire.MoireScreenGan().state_dict()
    assert gan["branches.4.non_local.non_local.theta.weight"].shape == (32, 64, 1, 1)
    assert "branches.1.non_local.non_local.g.weight" not in gan and "branches.4.u.3.2.weight" in gan
    assert "branches.4.s_conv.7.weight" in gan and "branches.4.s_conv.8.weight" not in gan
    assert gan["_down2.0.conv_input.weight"].shape == (64, 3, 3, 3) and "_down2.4.down.weight" not in gan
    assert gan["branches.0.conv_input2.weight"].shape == (3, 64, 3, 3) and gan["scales.4.scale"].shape == (1,)


MOIRE = {
    # image sizes two tiles high on which JAX's plan at align 32 is the port's at the entry's align
    "moire_obj": (lambda: demoire.MoireObj(OBJ_C), lambda: synth.synthMoireObjParams(OBJ_C, seed=12),
                  jaxDemoire.moireObj, (224, 120)),
    "moire_screen_gan": (lambda: demoire.MoireScreenGan(GAN_C), lambda: synth.synthMoireScreenGanParams(GAN_C, seed=13),
                         jaxDemoire.moireScreenGan, (960, 512)),
}


@pytest.mark.parametrize("key", list(MOIRE))
def test_tiled_moire_matches_jax(key):
    """Each entry's tile spec on an image two tiles high.  The JAX engine
    raises there at the entry's own spec (tile = align: its plan on the
    padded extent puts a tile past the end, as
    test_torch_tiling.py::test_tile_plan_covers_image_where_jax_overshoots
    records), so JAX runs the same tiles at align 32."""
    import jax.numpy as jnp

    make, makeSd, jaxFn, hw = MOIRE[key]
    sd = makeSd()
    model = make()
    model.load_state_dict(sd, strict=True)
    spec, jaxSpec = registry.DEHAZE_REGISTRY[key]["spec"], jaxRegistry.DEHAZE_REGISTRY[key]["spec"]
    assert spec.tile == spec.align
    x = np.random.RandomState(14).rand(*hw, 3).astype(np.float32)
    with pytest.raises(ValueError, match="same shape"):
        JaxModelExec(jaxFn, _jaxParams(sd), jaxSpec, dtype=jnp.float32)(x)
    got = ModelExec(model.eval(), spec, dtype=torch.float32, device="cpu")(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxModelExec(jaxFn, _jaxParams(sd), dataclasses.replace(jaxSpec, align=32),
                                  dtype=jnp.float32)(x))
    assert got.shape == ref.shape == (*hw, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)
