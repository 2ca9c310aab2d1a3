"""The port's AiLUT transform (moephoto_tpu_torch/ops/lut.py) against the
JAX package's: the exact XLA transform and the Pallas kernel
``ailutTransformPallasT`` in interpret mode.

Tolerance against the XLA transform: 1e-5 * max(1, |ref|) elementwise.
Both compute the same fp32 operations; only the order of the rounding
inside XLA's fused expressions may differ.  Out-of-range inputs
extrapolate to magnitudes well above 1, hence the relative part.
Against the Pallas kernel: JAX's own bound for it, 1e-4 of the largest
|ref| (``tests/test_ops.py``), since its bf16x2 split drops lo*lo terms.
"""

import functools

import numpy as np
import pytest
import torch

from moephoto_tpu.ops.lut import ailutTransform as jaxAilutTransform
from moephoto_tpu.ops.lutkernel import ailutTransformPallasT
from moephoto_tpu_torch.ops import lut

D = 33


def _case(seed, shape=(2, 40, 64, 3), lo=0.0, hi=1.0):
    """Image uniform in [lo, hi), random LUT, sorted non-uniform vertices
    from 0 to 1 (a softmax cumsum, as the model makes them)."""
    rng = np.random.RandomState(seed)
    B = shape[0]
    img = (rng.rand(*shape) * (hi - lo) + lo).astype(np.float32)
    table = rng.rand(B, 3, D, D, D).astype(np.float32)
    iv = rng.rand(B, 3, D - 1).astype(np.float32) + 0.05
    iv = iv / iv.sum(-1, keepdims=True)
    vert = np.pad(np.cumsum(iv, -1), ((0, 0), (0, 0), (1, 0))).astype(np.float32)
    return img, table, vert


def _jax(fn, img, table, vert):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(img), jnp.asarray(table), jnp.asarray(vert)))


def _port(img, table, vert, fn=lut.ailutTransformPlain):
    return fn(torch.from_numpy(img), torch.from_numpy(table), torch.from_numpy(vert)).numpy()


def _assertClose(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= 1e-5 * np.maximum(1.0, np.abs(ref))), float(err.max())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.4, 1.5)], ids=["in_range", "extrapolate"])
def test_plain_matches_jax_transform(lo, hi):
    img, table, vert = _case(1, lo=lo, hi=hi)
    ref = _jax(jaxAilutTransform, img, table, vert)
    _assertClose(_port(img, table, vert), ref)
    if lo < 0:  # the extrapolation branch really ran: outputs leave the LUT's range
        assert np.abs(ref).max() > 1.5


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.4, 1.5)], ids=["in_range", "extrapolate"])
def test_plain_matches_jax_pallas_kernel(lo, hi):
    img, table, vert = _case(2, lo=lo, hi=hi)
    ref = _jax(functools.partial(ailutTransformPallasT, interpret=True, exact=True), img, table, vert)
    got = _port(img, table, vert)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) / scale < 1e-4


def test_ties_follow_lower_bound():
    """Values equal to a vertex, below v[0] and above v[D-1]: the bin is
    #{v < x} - 1 clipped to [0, D-2], the fraction unclamped."""
    img, table, vert = _case(3, shape=(1, 6, 11, 3))
    for c in range(3):
        img[0, :3, :, c] = vert[0, c, ::3][:11]  # exact vertex values, v[0] and v[D-1] included
    img[0, 3, :, :] = vert[0, :, -1]  # the top vertex in every channel
    img[0, 4, :, :] = -0.25
    img[0, 5, :, :] = 1.25
    ref = _jax(jaxAilutTransform, img, table, vert)
    got = _port(img, table, vert)
    _assertClose(got, ref)
    # at a vertex the value is the LUT's own entry on that grid line
    r = img[0, 0, 0]
    idx = [int(np.argmax(vert[0, c] == r[c])) for c in range(3)]
    np.testing.assert_allclose(got[0, 0, 0], table[0, :, idx[2], idx[1], idx[0]], rtol=0, atol=1e-6)


def test_plain_keeps_bf16_images():
    img, table, vert = _case(4, shape=(1, 5, 7, 3))
    x = torch.from_numpy(img).to(torch.bfloat16)
    got = lut.ailutTransformPlain(x, torch.from_numpy(table), torch.from_numpy(vert))
    want = lut.ailutTransformPlain(x.float(), torch.from_numpy(table), torch.from_numpy(vert))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_takes_plain_path_on_cpu():
    img, table, vert = _case(5, shape=(1, 9, 13, 3), lo=-0.2, hi=1.2)
    before = lut.ailutTransform.launches
    got = _port(img, table, vert, fn=lut.ailutTransform)
    assert lut.ailutTransform.launches == before  # no kernel launched
    np.testing.assert_array_equal(got, _port(img, table, vert))


def test_wrapper_raises_off_cpu_without_kernel():
    """Tensors that are not on the CPU never fall back to the plain version."""
    img = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        lut.ailutTransform(img, torch.empty((1, 3, D, D, D), device="meta"),
                           torch.empty((1, 3, D), device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """CUDA kernel against its plain version on the card, in range, out of
    range, with ties, B = 2 with a ragged pixel count, fp32 and bf16.
    Tolerance 1e-5 * max(1, |plain|): the kernel rounds each operation
    where the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, shape, lo, hi in ((6, (1, 67, 129, 3), 0.0, 1.0), (7, (2, 33, 77, 3), -0.4, 1.5)):
        img, table, vert = _case(seed, shape, lo, hi)
        img[0, 0, :3] = vert[0, :, :3].T  # exact vertex values
        args = [torch.from_numpy(a).cuda() for a in (img, table, vert)]
        for dtype in (torch.float32, torch.bfloat16):
            x = args[0].to(dtype)
            before = lut.ailutTransform.launches
            got = lut.ailutTransform(x, *args[1:]).float()
            assert lut.ailutTransform.launches == before + 1
            want = lut.ailutTransformPlain(x, *args[1:]).float()
            tol = 1e-5 * want.abs().clamp_min(1.0)
            if dtype == torch.bfloat16:  # a sum near a rounding boundary may round the other way
                tol = tol + 2.0**-7 * want.abs()
            assert bool(((got - want).abs() <= tol).all()), (seed, dtype)
