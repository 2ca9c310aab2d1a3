"""The port's bilinear warp (moephoto_tpu_torch/ops/warp.py) against the
JAX package's: the exact XLA warp ``warpXLAExact``, the tiered Pallas
warp ``warpBounded`` in interpret mode (one case per tier), and
``backWarp``/``backWarpBounded``.

Tolerance 2e-5 absolute on values in [0, 1], as ``tests/test_ops.py``
holds the Pallas tiers against the XLA warp: the port samples at x + u
directly, JAX normalises to [-1, 1] and back, which moves a coordinate by
a few fp32 ulps.
"""

import functools

import numpy as np
import pytest
import torch

from moephoto_tpu.ops import warp as jaxWarp
from moephoto_tpu_torch.ops import warp as W
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

TOL = 2e-5


def _case(seed, shape=(2, 20, 28, 3), scale=6.0):
    rng = np.random.RandomState(seed)
    img = rng.rand(*shape).astype(np.float32)
    flow = ((rng.rand(*shape[:3], 2) * 2 - 1) * scale).astype(np.float32)
    return img, flow


def _jax(fn, img, flow, *args, **kw):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(img), jnp.asarray(flow), *args, **kw))


def _port(fn, img, flow, *args):
    return fn(torch.from_numpy(img), torch.from_numpy(flow), *args).numpy()


@pytest.mark.parametrize("C", [3, 32])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_plain_matches_jax_exact(mode, C):
    img, flow = _case(1, (2, 20, 28, C))
    ref = _jax(jaxWarp.warpXLAExact, img, flow, padding_mode=mode)
    got = _port(W.warpPlain, img, flow, mode)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("scale", [3.0, 13.0, 40.0], ids=["M8_tier", "M16_tier", "xla_fallback"])
def test_plain_matches_jax_pallas_tiers(scale):
    """warpBounded picks its tier from max |flow|: < 7 the M = 8 kernel,
    < 15 the M = 16 kernel, else the XLA gather.  The port has no tiers."""
    img, flow = _case(2, (1, 16, 40, 3), scale)
    bound = float(np.abs(flow).max())
    assert (bound < 7) if scale < 7 else (7 <= bound < 15) if scale < 15 else (bound >= 15)
    ref = _jax(functools.partial(jaxWarp.warpBounded, interpret=True), img, flow, "border")
    np.testing.assert_allclose(_port(W.warpPlain, img, flow, "border"), ref, atol=TOL, rtol=0)


def test_stride0_batch_is_read_in_place():
    """A batch broadcast by expand (stride 0) gives the same result as its
    contiguous copy, and as JAX on the copy."""
    img, flow = _case(3, (3, 12, 17, 32))
    one = torch.from_numpy(img[:1]).expand(3, -1, -1, -1)
    assert one.stride(0) == 0
    f = torch.from_numpy(flow)
    got = W.warp(one, f).numpy()
    np.testing.assert_array_equal(got, W.warpPlain(one.contiguous(), f).numpy())
    ref = _jax(jaxWarp.warpXLAExact, np.ascontiguousarray(one.numpy()), flow, padding_mode="border")
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_huge_and_nan_flows(mode):
    """|flow| = 1e6 samples the edge (border) or zero (zeros); a NaN flow
    gives NaN at its pixel, as JAX does; every other pixel is unchanged."""
    img, flow = _case(4, (1, 9, 13, 3), 2.0)
    flow[0, 1, 2] = (1e6, 0.0)
    flow[0, 3, 4] = (-1e6, 1e6)
    flow[0, 5, 6] = (np.nan, 0.0)
    flow[0, 7, 8] = (0.5, np.inf)
    ref = _jax(jaxWarp.warpXLAExact, img, flow, padding_mode=mode)
    got = _port(W.warpPlain, img, flow, mode)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan[0, 5, 6].all() and nan[0, 7, 8].all()
    np.testing.assert_allclose(got[~nan], ref[~nan], atol=TOL, rtol=0)
    if mode == "border":
        np.testing.assert_allclose(got[0, 1, 2], img[0, 1, -1], atol=TOL)
        np.testing.assert_allclose(got[0, 3, 4], img[0, -1, 0], atol=TOL)
    else:
        np.testing.assert_array_equal(got[0, 1, 2], 0.0)
        np.testing.assert_array_equal(got[0, 3, 4], 0.0)


def test_backwarp_matches_jax():
    """The port's backWarp (the quirk folded into the flow, then warp)
    against JAX backWarp and backWarpBounded (Pallas, interpret)."""
    img, flow = _case(5, (1, 16, 24, 3), 3.0)
    got = _port(W.backWarp, img, flow, "border")
    np.testing.assert_allclose(got, _jax(jaxWarp.backWarp, img, flow, "border"), atol=TOL, rtol=0)
    bounded = _jax(functools.partial(jaxWarp.backWarpBounded, interpret=True), img, flow, "border")
    np.testing.assert_allclose(got, bounded, atol=TOL, rtol=0)
    np.testing.assert_allclose(_port(W.backWarp, img, flow, "zeros"),
                               _jax(jaxWarp.backWarp, img, flow, "zeros"), atol=TOL, rtol=0)


def test_plain_blends_bf16_in_fp32():
    img, flow = _case(6, (1, 7, 9, 8))
    x, f = torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(flow).to(torch.bfloat16)
    got = W.warpPlain(x, f)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, W.warpPlain(x.float(), f.float()).to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_takes_plain_path_on_cpu():
    img, flow = _case(7, (1, 6, 10, 3))
    before = W.warp.launches
    got = _port(W.warp, img, flow)
    assert W.warp.launches == before  # no kernel launched
    np.testing.assert_array_equal(got, _port(W.warpPlain, img, flow))


def test_wrapper_raises_off_cpu_without_kernel():
    """Tensors that are not on the CPU never fall back to the plain version."""
    with pytest.raises(ValueError):
        W.warp(torch.empty((1, 4, 4, 3), device="meta"), torch.empty((1, 4, 4, 2), device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """CUDA kernel against its plain version on the card: C = 3 (pixel
    path) and C = 32, 36 (vector and pixel paths), both modes, fp32 and
    bf16 images with fp32 and bf16 flows, a stride-0 batch, huge and NaN
    flows.  The kernel rounds each fp32 operation where the plain version
    does, so they agree bit for bit (NaN where the plain version is NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, shape in ((8, (2, 33, 71, 3)), (9, (2, 24, 40, 32)), (10, (1, 17, 29, 36))):
        img, flow = _case(seed, shape, 30.0)
        flow[0, 0, 0] = (1e6, -1e6)
        flow[0, 1, 1] = (np.nan, 0.0)
        for it in (torch.float32, torch.bfloat16):
            for ft in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(img).cuda().to(it)
                f = torch.from_numpy(flow).cuda().to(ft)
                for mode in ("border", "zeros"):
                    for xs in (x, x[:1].expand_as(x)):
                        before = W.warp.launches
                        got = W.warp(xs, f, mode)
                        assert W.warp.launches == before + 1
                        want = W.warpPlain(xs, f, mode)
                        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
