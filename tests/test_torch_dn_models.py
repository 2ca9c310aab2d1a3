"""The port's MyNet family (moephoto_tpu_torch/models/sr.py ``MyNetSR``,
``NetDN``, ``SEDN``; models/blocks.py ``ARSB``) and its nearest and cubic
resizes (models/api.py) against the JAX package's.

One synthetic state dict per model goes to both: to the port as it is
(``load_state_dict(strict=True)``), to JAX through ``convertStateDict``.
The port writes the reference's graph (conv -> pixel shuffle -> PReLU;
gate, then the 1x1 ``trans`` conv); JAX runs its deferred sub-pixel form
and its folded SE form, so the comparison also holds those rewrites to
the plain graph.

Tolerance for the models: 2e-5 * max(1, |ref|) in fp32 at JAX precision
``highest``, the summation order of up to 35 conv layers.  For the
resizes: 1e-5 absolute on values in [0, 1) (the two build their fp32
weights in slightly different operation orders).
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.models import api as JA
from moephoto_tpu.models import blocks as jaxBlocks
from moephoto_tpu.models import sr as jaxSr
from moephoto_tpu_torch import synth
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import blocks, sr
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

MODEL_TOL = 2e-5


def _jaxParams(sd):
    import jax.numpy as jnp

    npd = {k: v.numpy() for k, v in sd.items()}
    return {k: jnp.asarray(v) for k, v in JA.convertStateDict(npd).items()}


def _assertClose(got, ref, tol=MODEL_TOL):
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), float(err.max())


def _plane(seed, shape=(1, 24, 32, 1)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


MODELS = {
    "net2x": (lambda: sr.net2x(), lambda: synth.synthMyNetParams(2, 5), jaxSr.net2x, 2),
    "net3x": (lambda: sr.net3x(), lambda: synth.synthMyNetParams(3, 6), jaxSr.net3x, 3),
    "net4x": (lambda: sr.net4x(), lambda: synth.synthMyNetParams(4, 7), jaxSr.net4x, 4),
    "netDN": (lambda: sr.netDN(), lambda: synth.synthNetDNParams(8), jaxSr.netDN, 1),
    "sedn": (lambda: sr.sedn(), lambda: synth.synthSEDNParams(9), jaxSr.sedn, 1),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    import jax.numpy as jnp

    make, makeSd, jaxFn, scale = MODELS[name]
    sd = makeSd()
    model = make()
    model.load_state_dict(sd, strict=True)
    x = _plane(1)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxFn(_jaxParams(sd), jnp.asarray(x)))
    assert got.shape == (1, 24 * scale, 32 * scale, 1)
    _assertClose(got, ref)
    assert got.std() > 1e-3  # the heads are not silent


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trips_through_the_jax_layout(name):
    """``fromJaxParams`` inverts ``convertStateDict`` on every key, and the
    result loads strictly: the .npz a JAX converter writes serves the port."""
    make, makeSd, _, _ = MODELS[name]
    sd = makeSd()
    back = PA.fromJaxParams({k: np.asarray(v) for k, v in _jaxParams(sd).items()})
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    make().load_state_dict(back, strict=True)
    with pytest.raises(RuntimeError):
        make().load_state_dict({k: v for k, v in sd.items() if k != "conv_input.weight"}, strict=True)


def test_arsb_matches_jax_and_its_keys():
    import jax.numpy as jnp

    block = blocks.ARSB(12)
    assert list(block.state_dict()) == ["0.conv_1.weight", "0.relu.weight", "0.conv_2.weight", "0.scale.scale"]
    rng = np.random.RandomState(2)
    sd = {"0.conv_1.weight": rng.randn(12, 12, 3, 3) / 10, "0.relu.weight": np.array([0.2]),
          "0.conv_2.weight": rng.randn(12, 12, 3, 3) / 10, "0.scale.scale": np.array([0.7])}
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    block.load_state_dict(sd, strict=True)
    x = rng.rand(2, 9, 11, 12).astype(np.float32)
    with torch.inference_mode():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    params = _jaxParams({"blk." + k: v for k, v in sd.items()})
    ref = np.asarray(jaxBlocks.arsb(params, "blk", jnp.asarray(x)))
    _assertClose(got, ref)
    # the learned scale really multiplies the branch
    block[0].scale.scale.data.zero_()
    with torch.inference_mode():
        same = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(same, x)


def test_mynet_slopes_are_scalars_and_up_convs_carry_bias():
    sd = synth.synthMyNetParams(4, 0)
    assert sd["relu.weight"].shape == sd["convt_F3.0.relu.weight"].shape == sd["u.1.2.weight"].shape == (1,)
    assert sd["u.0.0.weight"].shape == (256, 64, 3, 3) and sd["u.0.0.bias"].shape == (256,)
    assert sd["u.2.weight"].shape == (1, 64, 3, 3) and "u.2.bias" not in sd
    assert synth.synthMyNetParams(3, 0)["convt_R1.0.0.weight"].shape == (576, 64, 3, 3)
    dn = synth.synthNetDNParams(0)
    assert dn["conv_input.weight"].shape == (48, 1, 3, 3) and dn["u.weight"].shape == (1, 48, 3, 3)
    se = synth.synthSEDNParams(0)
    assert len(se) == 2 + 16 * 6 and not any(k.endswith(".bias") for k in se)
    assert [tuple(se[f"convt_F1.15.{k}.weight"].shape[:2]) for k in
            ("rblock.0", "rblock.2", "rblock.4", "conv_down", "conv_up", "trans.0")] == [
        (128, 64), (256, 128), (256, 256), (16, 256), (256, 16), (64, 256)]


def test_sedn_gate_is_taken_in_fp32_on_a_bf16_model():
    """bf16 weights and activations, the squeeze path in fp32: the result
    stays within bf16 rounding of the fp32 model's."""
    model = sr.sedn()
    model.load_state_dict(synth.synthSEDNParams(9), strict=True)
    x = torch.from_numpy(_plane(3))
    with torch.inference_mode():
        ref = model.eval()(x)
        got = model.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert float((got.float() - ref).abs().max()) < 0.05


SIZES = [((17, 23), (29, 31)), ((17, 23), (7, 10)), ((16, 24), (32, 48)), ((30, 45), (20, 30)),
         ((17, 23), (17, 40)), ((12, 9), (5, 9))]
IDS = ["up_fractional", "down_fractional", "up_2x", "down_1.5x", "one_axis_up", "one_axis_down"]


@pytest.mark.parametrize("inHW,outHW", SIZES, ids=IDS)
def test_resize_nearest_matches_jax(inHW, outHW):
    """Half-pixel centres: at a non-integer ratio ``F.interpolate``'s
    ``nearest`` picks other pixels."""
    import jax.numpy as jnp

    x = _plane(4, (2, *inHW, 3))
    got = PA.resizeNearest(torch.from_numpy(x), *outHW).numpy()
    ref = np.asarray(JA.resizeNearest(jnp.asarray(x), *outHW))
    np.testing.assert_array_equal(got, ref)
    if inHW == (17, 23) and outHW == (29, 31):
        legacy = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=outHW,
                                                 mode="nearest").permute(0, 2, 3, 1).numpy()
        assert not np.array_equal(legacy, ref)


@pytest.mark.parametrize("inHW,outHW", SIZES, ids=IDS)
def test_resize_cubic_matches_jax(inHW, outHW):
    """Keys a = -0.5, antialiased when shrinking, weights renormalised at
    the border: ``F.interpolate``'s ``bicubic`` is another function."""
    import jax
    import jax.numpy as jnp

    x = _plane(5, (2, *inHW, 3))
    got = PA.resizeCubic(torch.from_numpy(x), *outHW).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *outHW, 3), "cubic"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    torchBicubic = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=outHW,
                                                   mode="bicubic", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(torchBicubic - ref).max() > 1e-3


def test_cubic_weights_sum_to_one_and_widen_when_shrinking():
    up, down = PA.cubicWeights(10, 25), PA.cubicWeights(30, 10)
    np.testing.assert_allclose(up.sum(0).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(down.sum(0).numpy(), 1.0, atol=1e-6)
    assert int((up[:, 12] != 0).sum()) <= 4  # interpolating: four taps
    assert int((down[:, 5] != 0).sum()) > 8  # antialiased: the kernel is three times as wide
