"""The port's clamping AiLUT transform (moephoto_tpu_torch/ops/lut.py
``ailutTransformClamped``) against the JAX package's: the Pallas kernel
``ailutTransformPallas`` in interpret mode, and the exact XLA transform on
inputs clipped to the range the kernel clips to.

Tolerances.  Against the Pallas kernel: 1e-2 absolute, the JAX package's
own bound for it (``tests/test_ops.py``), since its main product runs with
bf16 operands (~4e-3 relative) where the port computes fp32.  Against the
XLA transform on clipped inputs: 1e-5 * max(1, |ref|) elementwise; both
compute the same fp32 operations.

Vertices are strictly increasing throughout: on equal neighbours the TPU
body divides by zero and gives NaN, where the port's lookup stays finite.
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.ops.lut import ailutTransform as jaxAilutTransform
from moephoto_tpu.ops.lutkernel import ailutTransformPallas
from moephoto_tpu_torch.ops import lut

D = 33


def _case(seed, shape=(2, 24, 40, 3), lo=0.0, hi=1.0, ranges=((0.0, 1.0),) * 3):
    """Image uniform in [lo, hi), random LUT, and per channel strictly
    increasing non-uniform vertices from ``ranges[c][0]`` to
    ``ranges[c][1]``."""
    rng = np.random.RandomState(seed)
    B = shape[0]
    img = (rng.rand(*shape) * (hi - lo) + lo).astype(np.float32)
    table = rng.rand(B, 3, D, D, D).astype(np.float32)
    iv = rng.rand(B, 3, D - 1).astype(np.float32) + 0.05
    iv = iv / iv.sum(-1, keepdims=True)
    unit = np.pad(np.cumsum(iv, -1), ((0, 0), (0, 0), (1, 0)))
    a = np.array([r[0] for r in ranges], np.float32)[None, :, None]
    b = np.array([r[1] for r in ranges], np.float32)[None, :, None]
    vert = (a + (b - a) * unit).astype(np.float32)
    assert np.all(np.diff(vert, axis=-1) > 0)
    return img, table, vert


def _jax(fn, img, table, vert, **kw):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(img), jnp.asarray(table), jnp.asarray(vert), **kw))


def _port(img, table, vert, fn=lut.ailutTransformClampedPlain):
    return fn(torch.from_numpy(img), torch.from_numpy(table), torch.from_numpy(vert)).numpy()


def _clipped(img, vert):
    lo = vert[:, :, 0].max(axis=1)[:, None, None, None]
    hi = vert[:, :, -1].min(axis=1)[:, None, None, None]
    return np.minimum(np.maximum(img, lo), hi), lo, hi


SHIFTED = ((0.05, 0.9), (0.0, 1.0), (0.1, 0.95))  # lo = 0.1 from blue, hi = 0.9 from red


def test_plain_matches_jax_pallas_kernel_in_range():
    """B = 2, D = 33, inputs inside every channel's vertex range."""
    img, table, vert = _case(1)
    ref = _jax(ailutTransformPallas, img, table, vert, interpret=True)
    got = _port(img, table, vert)
    assert got.shape == ref.shape == img.shape
    assert float(np.abs(got - ref).max()) < 1e-2


def test_plain_matches_jax_pallas_kernel_where_the_clamp_bites():
    """Inputs on [-0.4, 1.5] and differing channel ranges: the kernel holds
    the edge of the common range [0.1, 0.9] where K4 would extrapolate."""
    img, table, vert = _case(2, lo=-0.4, hi=1.5, ranges=SHIFTED)
    ref = _jax(ailutTransformPallas, img, table, vert, interpret=True)
    got = _port(img, table, vert)
    assert float(np.abs(got - ref).max()) < 1e-2
    assert float(np.abs(got).max()) <= 1.0 + 1e-5  # nothing extrapolated


@pytest.mark.parametrize("ranges", [((0.0, 1.0),) * 3, SHIFTED], ids=["equal_ranges", "differing_ranges"])
def test_plain_matches_jax_transform_on_clipped_inputs(ranges):
    img, table, vert = _case(3, lo=-0.4, hi=1.5, ranges=ranges)
    clipped, lo, hi = _clipped(img, vert)
    assert (img < lo).any() and (img > hi).any()
    ref = _jax(jaxAilutTransform, clipped, table, vert)
    got = _port(img, table, vert)
    err = np.abs(got - ref)
    assert np.all(err <= 1e-5 * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_common_range_is_max_of_firsts_and_min_of_lasts():
    _, _, vert = _case(4, ranges=SHIFTED)
    lo, hi = lut.clampRange(torch.from_numpy(vert))
    np.testing.assert_array_equal(lo.numpy(), vert[:, 2, 0])  # blue starts last, at 0.1
    np.testing.assert_array_equal(hi.numpy(), vert[:, 0, -1])  # red ends first, at 0.9
    np.testing.assert_allclose(lo.numpy(), 0.1, atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), 0.9, atol=1e-6)
    # a channel whose own range is wider is clipped to the common one all the same
    img, table, _ = _case(4, shape=(2, 4, 5, 3))
    img[..., 1] = 0.02  # inside green's [0, 1], below lo
    low, _, _ = _clipped(img, vert)
    assert np.all(low[..., 1] == lo.numpy()[:, None, None]) and not np.array_equal(low, img)
    np.testing.assert_array_equal(_port(img, table, vert), _port(low, table, vert))


def test_nan_pixel_stays_nan():
    """``min(max(x, lo), hi)`` propagates NaN, as ``jnp.clip`` does."""
    img, table, vert = _case(5, shape=(1, 6, 7, 3))
    img[0, 2, 3, 1] = np.nan
    got = _port(img, table, vert)
    assert np.isnan(got[0, 2, 3]).all()
    got[0, 2, 3] = 0
    assert np.isfinite(got).all()
    import jax.numpy as jnp

    clipped = np.asarray(jnp.clip(jnp.asarray(img), 0.0, 1.0))
    assert np.isnan(clipped[0, 2, 3, 1])


def test_disjoint_ranges_give_hi():
    """lo > hi (red's range lies above blue's): every pixel becomes hi, as
    ``jnp.clip(x, lo, hi)`` gives."""
    img, table, vert = _case(6, shape=(1, 5, 6, 3), ranges=((0.6, 1.0), (0.0, 1.0), (0.0, 0.4)))
    lo, hi = lut.clampRange(torch.from_numpy(vert))
    assert float(lo) == pytest.approx(0.6) and float(hi) == pytest.approx(0.4)
    import jax.numpy as jnp

    clipped = np.asarray(jnp.clip(jnp.asarray(img), float(lo), float(hi)))
    np.testing.assert_array_equal(clipped, np.full_like(img, float(hi)))
    got = _port(img, table, vert)
    ref = _jax(jaxAilutTransform, clipped, table, vert)
    err = np.abs(got - ref)
    assert np.all(err <= 1e-5 * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_equals_extrapolating_transform_inside_the_range():
    img, table, vert = _case(7, lo=0.1, hi=0.9, ranges=SHIFTED)
    args = [torch.from_numpy(a) for a in (img, table, vert)]
    torch.testing.assert_close(lut.ailutTransformClampedPlain(*args), lut.ailutTransformPlain(*args),
                               rtol=0, atol=0)
    out = _case(7, lo=-0.4, hi=1.5, ranges=SHIFTED)
    args = [torch.from_numpy(a) for a in out]
    assert not torch.equal(lut.ailutTransformClampedPlain(*args), lut.ailutTransformPlain(*args))


def test_plain_keeps_bf16_images():
    """A bf16 image is clipped and looked up in fp32 and rounded once."""
    img, table, vert = _case(8, shape=(1, 5, 7, 3), lo=-0.4, hi=1.5, ranges=SHIFTED)
    x = torch.from_numpy(img).to(torch.bfloat16)
    got = lut.ailutTransformClampedPlain(x, torch.from_numpy(table), torch.from_numpy(vert))
    want = lut.ailutTransformClampedPlain(x.float(), torch.from_numpy(table), torch.from_numpy(vert))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_takes_plain_path_on_cpu():
    img, table, vert = _case(9, shape=(1, 9, 13, 3), lo=-0.2, hi=1.2)
    before = lut.ailutTransformClamped.launches
    got = _port(img, table, vert, fn=lut.ailutTransformClamped)
    assert lut.ailutTransformClamped.launches == before  # no kernel launched
    np.testing.assert_array_equal(got, _port(img, table, vert))


def test_wrapper_raises_off_cpu_without_kernel():
    """Tensors that are not on the CPU never fall back to the plain version."""
    img = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        lut.ailutTransformClamped(img, torch.empty((1, 3, D, D, D), device="meta"),
                                  torch.empty((1, 3, D), device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """CUDA kernel against its plain version on the card: out of range with
    differing channel ranges, B = 2 with a ragged pixel count, a NaN pixel,
    disjoint ranges, fp32 and bf16.  Tolerance 1e-5 * max(1, |plain|): the
    kernel rounds each operation where the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disjoint = ((0.6, 1.0), (0.0, 1.0), (0.0, 0.4))
    for seed, shape, ranges in ((10, (1, 67, 129, 3), SHIFTED), (11, (2, 33, 77, 3), SHIFTED),
                                (12, (1, 16, 31, 3), disjoint)):
        img, table, vert = _case(seed, shape, -0.4, 1.5, ranges)
        img[0, 1, 2, 0] = np.nan
        args = [torch.from_numpy(a).cuda() for a in (img, table, vert)]
        for dtype in (torch.float32, torch.bfloat16):
            x = args[0].to(dtype)
            before = lut.ailutTransformClamped.launches
            got = lut.ailutTransformClamped(x, *args[1:]).float()
            assert lut.ailutTransformClamped.launches == before + 1
            want = lut.ailutTransformClampedPlain(x, *args[1:]).float()
            nan = torch.isnan(want)
            assert bool(nan[0, 1, 2].all()) and torch.equal(torch.isnan(got), nan)
            tol = 1e-5 * want.abs().clamp_min(1.0)
            if dtype == torch.bfloat16:  # a sum near a rounding boundary may round the other way
                tol = tol + 2.0**-7 * want.abs()
            assert bool(((got - want).abs()[~nan] <= tol[~nan]).all()), (seed, dtype)
