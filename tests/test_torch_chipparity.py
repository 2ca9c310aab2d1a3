"""The port's kernel parity gate (moephoto_tpu_torch/tools/chipparity.py)
against the JAX package's (tools/chipparity.py): the same cases from the
same seed, each through the JAX kernel in interpret mode (or, for the
``_rel`` case, the exact XLA transform, as the JAX gate itself does) and
through the port's plain version.

Tolerances of port-plain against JAX-interpret, each case at its working
type:
  dcnDensePallas (bf16)   2^-7 |ref| + 2^-8: bf16 rounds the output once,
                          and the sums differ in order
  warpBounded, backWarpBounded (bf16)  2^-7 + 2^-8 on values in [0, 1)
  fusedUpHeads (bf16)     2^-6 |ref| + 2^-6: a stage value near a rounding
                          boundary may round the other way
  ailutTransformPallas    1e-2, the JAX package's own bound for this
                          kernel (bf16 operands in its main product)
  ailutTransformPallasT_rel  1e-5 of the largest |ref|
"""

import functools

import numpy as np
import pytest
import torch

from moephoto_tpu_torch.tools import chipparity

KEYS = ("dcnDensePallas", "warpBounded", "backWarpBounded", "fusedUpHeads", "ailutTransformPallas",
        "ailutTransformPallasT_rel")


@pytest.fixture(scope="module")
def cases():
    return chipparity.buildCases()


def test_case_shapes_and_types_follow_the_jax_gate(cases):
    assert tuple(cases) == KEYS
    shapes = lambda key: {k: a.shape for k, a in cases[key]["arrays"].items()}
    assert shapes("dcnDensePallas") == {"x": (1, 16, 128, 64), "offset": (1, 16, 128, 8, 9, 2),
                                        "mask": (1, 16, 128, 8, 9), "weight": (3, 3, 64, 64), "bias": (64,)}
    assert set(cases["dcnDensePallas"]["dtypes"].values()) == {"bfloat16"} and cases["dcnDensePallas"]["dg"] == 8
    assert np.abs(cases["dcnDensePallas"]["arrays"]["offset"]).max() <= 2
    assert shapes("warpBounded") == {"img": (1, 24, 192, 3), "flow": (1, 24, 192, 2)}
    assert cases["warpBounded"]["dtypes"] == {"img": "bfloat16", "flow": "float32"}
    assert np.abs(cases["warpBounded"]["arrays"]["flow"]).max() <= 4
    assert cases["backWarpBounded"] is cases["warpBounded"]
    assert shapes("fusedUpHeads") == {"res": (512, 48), "im": (512, 48)} and cases["fusedUpHeads"]["nUps"] == 1
    assert cases["fusedUpHeads"]["params"]["ures.0.0.weight"].shape == (1, 1, 48, 192)  # HWIO
    lutShapes = {"img": (1, 32, 64, 3), "lut": (1, 3, 33, 33, 33), "vertices": (1, 3, 33)}
    assert shapes("ailutTransformPallas") == shapes("ailutTransformPallasT_rel") == lutShapes
    vert = cases["ailutTransformPallas"]["arrays"]["vertices"]
    assert np.all(np.diff(vert, axis=-1) > 0) and vert.min() == 0
    img, imgX = (cases[k]["arrays"]["img"] for k in KEYS[4:])
    assert 0 <= img.min() and img.max() < 1 and imgX.min() < -0.3 and imgX.max() > 1.4
    assert all(a.dtype == np.float32 for c in cases.values() for a in c["arrays"].values())


def test_draws_are_the_jax_gates(cases):
    """The same RandomState(7) stream in the same order: the first and the
    last draw of the JAX gate, re-drawn here as it draws them."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 16, 128, 64).astype(np.float32)
    np.testing.assert_array_equal(cases["dcnDensePallas"]["arrays"]["x"], x)
    rng.rand(1, 16, 128, 8, 9, 2), rng.rand(1, 16, 128, 8, 9), rng.randn(3, 3, 64, 64), rng.randn(64)
    rng.rand(1, 24, 192, 3), rng.rand(1, 24, 192, 2), rng.randn(512, 48), rng.randn(512, 48)
    rng.rand(1, 32, 64, 3), rng.rand(1, 3, 33, 33, 33), rng.rand(1, 3, 32)
    imgX = (rng.rand(1, 32, 64, 3) * 1.9 - 0.4).astype(np.float32)
    np.testing.assert_array_equal(cases["ailutTransformPallasT_rel"]["arrays"]["img"], imgX)
    from __graft_entry__ import _lite2Params

    ref = _lite2Params(2, seed=3, random=True)
    for k, v in cases["fusedUpHeads"]["params"].items():
        np.testing.assert_array_equal(v, np.asarray(ref[k], np.float32), err_msg=k)


def _jaxReference(key, case):
    """The case through the JAX package: what its gate calls ``want``."""
    import jax.numpy as jnp

    from moephoto_tpu.ops.dcnkernel import dcnDensePallas
    from moephoto_tpu.ops.fusedup import fusedUpHeads
    from moephoto_tpu.ops.lut import ailutTransform
    from moephoto_tpu.ops.lutkernel import ailutTransformPallas
    from moephoto_tpu.ops.warp import backWarpBounded, warpBounded

    a = {k: jnp.asarray(v, getattr(jnp, case["dtypes"][k])) for k, v in case["arrays"].items()}
    if key == "dcnDensePallas":
        fn = functools.partial(dcnDensePallas, dg=case["dg"], padding=1, dilation=1, margin=case["margin"],
                               interpret=True)
        out = fn(a["x"], a["offset"], a["mask"], a["weight"], a["bias"])
    elif key in ("warpBounded", "backWarpBounded"):
        out = {"warpBounded": warpBounded, "backWarpBounded": backWarpBounded}[key](a["img"], a["flow"],
                                                                                    interpret=True)
    elif key == "fusedUpHeads":
        params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in case["params"].items()}
        out = fusedUpHeads(params, a["res"], a["im"], case["nUps"], tileRows=512, interpret=True)
    elif key == "ailutTransformPallas":
        out = ailutTransformPallas(a["img"], a["lut"], a["vertices"], interpret=True)
    else:
        out = ailutTransform(a["img"], a["lut"], a["vertices"])
    return np.asarray(out.astype(jnp.float32))


BF16 = lambda rel, floor: (lambda ref: rel * np.abs(ref) + floor)
CPU_TOL = {
    "dcnDensePallas": BF16(2.0**-7, 2.0**-8),
    "warpBounded": BF16(0.0, 2.0**-7 + 2.0**-8),
    "backWarpBounded": BF16(0.0, 2.0**-7 + 2.0**-8),
    "fusedUpHeads": BF16(2.0**-6, 2.0**-6),
    "ailutTransformPallas": lambda ref: 1e-2,
    "ailutTransformPallasT_rel": lambda ref: 1e-5 * np.abs(ref).max(),
}


@pytest.mark.parametrize("key", KEYS)
def test_plain_version_matches_jax_kernel_on_the_gates_inputs(cases, key):
    case = cases[key]
    kernel, plain, wrapper = chipparity.portCalls(key, case, "cpu")
    got = plain().float().numpy()
    ref = _jaxReference(key, case)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert np.all(err <= CPU_TOL[key](ref)), float(err.max())
    if key in chipparity.MAGNITUDE:  # the magnitude its absolute tolerance assumes
        assert np.abs(got).max() <= chipparity.MAGNITUDE[key]
    before = wrapper.launches
    assert torch.equal(kernel(), plain()) and wrapper.launches == before  # CPU tensors: the plain path


def test_run_all_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        chipparity.runAll()


def test_assert_all_holds_each_key_to_its_tolerance():
    good = {k: 0.5 * t for k, t in chipparity.TOLERANCES.items()}
    chipparity.assertAll(good)
    chipparity.assertAll(dict.fromkeys(KEYS, 0.0))
    assert set(chipparity.TOLERANCES) == set(KEYS)
    for key in KEYS:
        with pytest.raises(AssertionError, match=key):
            chipparity.assertAll({**good, key: 1.01 * chipparity.TOLERANCES[key]})
        with pytest.raises(AssertionError, match=key):
            chipparity.assertAll({**good, key: float("nan")})
    # the fp32 kernels are held far tighter than the TPU gate's blanket 2e-2
    assert chipparity.TOLERANCES["ailutTransformPallas"] < 1e-4 < 2e-2


def test_measure_is_maxabs_and_relative_for_rel_keys():
    a, b = np.array([1.0, -4.0], np.float32), np.array([1.5, -4.0], np.float32)
    assert chipparity.measure("warpBounded", a, b) == 0.5
    assert chipparity.measure("ailutTransformPallasT_rel", a, b) == 0.125
    assert np.isnan(chipparity.measure("warpBounded", np.array([np.nan], np.float32), b[:1]))


@pytest.mark.cuda
def test_gate_passes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    results = chipparity.runAll()
    assert tuple(results) == KEYS
    chipparity.assertAll(results)
