"""The port's retouch-chain models (moephoto_tpu_torch/models/demoire.py
SunDemoire, restore.py AODNet, ailut.py AiLUT) against the JAX package's
sunDemoire, aodNet, ailutTPAMI and ailutRes18, and the weight carry
between the two layouts (models/api.py fromJaxParams, loadTorchWeights).

Weights are drawn once in torch layout (moephoto_tpu_torch/synth.py);
JAX gets them through its convertStateDict, the port through
fromJaxParams on the converted dict, so the carry is what is tested.
JAX runs in fp32 at 'highest' precision on the CPU.

Tolerances, absolute in fp32: sun 2e-5 (seventeen conv layers of up to
576-term sums, outputs of order 1, sum order differs between torch and
XLA); AOD 1e-5 (five convs of at most 108 terms); AiLUT 1e-5 on the
codes and the LUT (the backbone's sums reach 1152 terms, but the codes
pass through linears scaled down by the synthetic weights), and
5e-5 * max(1, |ref|) on the image: the codes differ by up to ~6e-7
(sum order), and outside the vertex range a fraction of several units
divided by an interval of ~0.03 amplifies a vertex's error up to ~50x
(measured gap 2.3e-5 at |ref| = 1.9).
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.models import ailut as jaxAilut
from moephoto_tpu.models.api import convertStateDict, saveParams
from moephoto_tpu.models.demoire import sunDemoire as jaxSun
from moephoto_tpu.models.restore import aodNet as jaxAod
from moephoto_tpu.pipeline.registry import _sunConvT as jaxSunConvT
from moephoto_tpu_torch.models.ailut import AiLUT
from moephoto_tpu_torch.models.api import fromJaxParams, loadTorchWeights
from moephoto_tpu_torch.models.demoire import SunDemoire
from moephoto_tpu_torch.models.restore import AODNet
from moephoto_tpu_torch.pipeline.registry import _sunConvT
from moephoto_tpu_torch.synth import synthAiLUTParams, synthAODParams, synthSunParams
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

CASES = {
    "sun": (lambda: synthSunParams(5), SunDemoire, _sunConvT),
    "aod": (lambda: synthAODParams(6), AODNet, None),
    "ailut_tpami3": (lambda: synthAiLUTParams("tpami", 3, 7), lambda: AiLUT(3, 33, "tpami"), None),
    "ailut_res18_5": (lambda: synthAiLUTParams("res18", 5, 8), lambda: AiLUT(5, 33, "res18"), None),
}


def _carry(name):
    """(torch-layout dict, JAX params, the port's dict carried back)."""
    make, _, convT = CASES[name]
    sd = make()
    jp = convertStateDict({k: v.numpy() for k, v in sd.items()}, convT)
    return sd, jp, fromJaxParams(jp, convT)


def _jaxRun(fn, jp, x):
    import jax.numpy as jnp

    return np.asarray(fn({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x)))


def _portRun(name, sd, x):
    model = CASES[name][1]()
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_carried_dict_loads_strictly_and_round_trips(name):
    sd, _, back = _carry(name)
    model = CASES[name][1]()
    model.load_state_dict(back, strict=True)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_sun_matches_jax():
    sd, jp, back = _carry("sun")
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    ref = _jaxRun(jaxSun, jp, x)
    got = _portRun("sun", back, x)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_aod_matches_jax():
    sd, jp, back = _carry("aod")
    x = (np.random.RandomState(1).rand(2, 48, 40, 3) * 2 - 1).astype(np.float32)
    ref = _jaxRun(jaxAod, jp, x)
    got = _portRun("aod", back, x)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,jaxFn", [("ailut_tpami3", jaxAilut.ailutTPAMI),
                                        ("ailut_res18_5", jaxAilut.ailutRes18)])
def test_ailut_matches_jax(name, jaxFn):
    """JAX on the CPU takes its exact XLA transform; the port its plain
    version.  Inputs reach past [0, 1], as AOD's output does."""
    sd, jp, back = _carry(name)
    x = (np.random.RandomState(2).rand(1, 40, 56, 3) * 1.2 - 0.1).astype(np.float32)
    ref = _jaxRun(jaxFn, jp, x)
    got = _portRun(name, back, x)
    err = np.abs(got - ref)
    assert np.all(err <= 5e-5 * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_ailut_lut_and_vertices_match_jax():
    """The generated LUT and vertices themselves, through the JAX
    function's own linears (the LUT is not otherwise exposed there)."""
    import jax.numpy as jnp

    from moephoto_tpu.models.api import linear, resizeBilinear

    sd, jp, back = _carry("ailut_tpami3")
    x = np.random.RandomState(3).rand(1, 40, 56, 3).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jp.items()}
    feat = jaxAilut._tpamiBackbone(p, resizeBilinear(jnp.asarray(x), 256, 256), extraPooling=True)
    codes = jnp.transpose(feat, (0, 3, 1, 2)).reshape(1, -1)
    lutRef = np.asarray(linear(p, "lut_generator.basis_luts_bank",
                               linear(p, "lut_generator.weights_generator", codes)))
    model = AiLUT(3, 33, "tpami")
    model.load_state_dict(back, strict=True)
    with torch.inference_mode():
        gotCodes, luts, vertices = model.eval().generate(torch.from_numpy(x))
    np.testing.assert_allclose(gotCodes.numpy(), np.asarray(codes), atol=1e-5, rtol=0)
    np.testing.assert_allclose(luts.numpy().reshape(1, -1), lutRef, atol=1e-5, rtol=0)
    assert vertices.shape == (1, 3, 33)
    assert bool((vertices[..., 0] == 0).all()) and bool((vertices.diff(dim=-1) > 0).all())


@pytest.mark.parametrize("inHW,outHW", [((1080 // 4, 1920 // 4), (256, 256)), ((40, 56), (224, 224))],
                         ids=["shrink", "grow"])
def test_resize_bilinear_matches_jax(inHW, outHW):
    """The backbone's input resize: a 1080p frame shrinks to 256 px, where
    antialiasing would change every value; neither package applies it."""
    import jax.numpy as jnp

    from moephoto_tpu.models.api import resizeBilinear as jaxResize
    from moephoto_tpu_torch.models.api import resizeBilinear

    x = np.random.RandomState(10).rand(1, *inHW, 3).astype(np.float32)
    ref = np.asarray(jaxResize(jnp.asarray(x), *outHW))
    got = resizeBilinear(torch.from_numpy(x), *outHW).numpy()
    assert got.shape == ref.shape == (1, *outHW, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_convt_npz_round_trip(tmp_path):
    """A JAX-converted .npz beside a .pth loads back to the torch dict;
    without the ConvTranspose predicate it would load, wrongly, without
    an error (the sun kernels are square and 64 -> 64)."""
    sd = synthSunParams(9)
    saveParams(convertStateDict({k: v.numpy() for k, v in sd.items()}, jaxSunConvT),
               str(tmp_path / "sun.npz"))
    path = str(tmp_path / "sun.pth")  # only the .npz exists: it is preferred
    back = loadTorchWeights(path, _sunConvT)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    plain = loadTorchWeights(path)
    key = "branches.1.0.weight"
    assert plain[key].shape == sd[key].shape and not torch.equal(plain[key], sd[key])


def test_ailut_backbone_runs_without_tf32_whatever_the_flags():
    """The module switches TF32 off around its backbone and linears
    itself and gives the process-wide flags back as it found them."""
    model = AiLUT(3, 33, "tpami")
    model.load_state_dict(synthAiLUTParams("tpami", 3, 1), strict=True)
    seen = []
    model.backbone.register_forward_pre_hook(lambda m, a: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            model.eval().generate(torch.rand(1, 16, 24, 3))
        assert seen == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
