"""The port's DCNv2 (moephoto_tpu_torch/ops/deform.py) against the JAX
package's: the exact gather path ``_deformConvGather``, the tiers of
``deformConv2d`` (M = 1, M = 3, gather), the Pallas kernel
``dcnDensePallas`` in interpret mode, and ``modulatedDeformConvPack``.
Shapes as ``tests/test_ops.py`` holds the JAX paths: dg 2 and 4, and a
ragged W = 184.

Tolerance 2e-5 absolute in fp32, as ``tests/test_ops.py`` holds the
Pallas kernel against the gather path: outputs are sums of 9 C products
of values in [0, 1], taken in another order (the JAX dense tiers sum hat
weights over a shift window, the port blends two corners per axis).
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.ops import deform as jaxDeform
from moephoto_tpu.ops.dcnkernel import dcnDensePallas
from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.ops import deform as D
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

TOL = 2e-5
# bf16 against the Pallas body in bf16: both round each sampled value to
# bf16 (one ulp apart where their fp32 sums differ) and the output once
# (JAX twice, around the bias); allow 2^-7 of |ref| (one to two ulps)
# plus a floor of 2^-8 for outputs near zero
BF16_REL, BF16_ABS = 2.0**-7, 2.0**-8


def _case(seed, B, H, W, C, Cout, dg, scale):
    """x, mask in [0, 1), offsets uniform in [-scale/2, scale/2), HWIO
    weights and bias as tests/test_ops.py draws them."""
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, C).astype(np.float32)
    off = ((rng.rand(B, H, W, dg, 9, 2) - 0.5) * scale).astype(np.float32)
    m = rng.rand(B, H, W, dg, 9).astype(np.float32)
    w = (rng.rand(3, 3, C, Cout) * 0.1).astype(np.float32)
    b = rng.rand(Cout).astype(np.float32)
    return x, off, m, w, b


def _jax(fn, x, off, m, w, b, *args, **kw):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(x), jnp.asarray(off), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b),
                         *args, **kw)).astype(np.float32)


def _port(fn, x, off, m, w, b, dg, dtype=torch.float32):
    B, H, W = x.shape[:3]
    t = lambda a: torch.from_numpy(np.array(a)).to(dtype)
    got = fn(t(x), t(off).reshape(B, H, W, -1), t(m).reshape(B, H, W, -1),
             torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b), dg)
    return got.float().numpy()


SHAPES = {"dg2_12x9": (2, 12, 9, 8, 4, 2), "dg4_16x12": (2, 16, 12, 16, 8, 4),
          "dg4_ragged_8x184": (1, 8, 184, 16, 8, 4)}


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_plain_matches_jax_gather(shape):
    x, off, m, w, b = _case(1, *shape, scale=5.8)
    ref = _jax(jaxDeform._deformConvGather, x, off, m, w, b, shape[-1], 1, 1)
    got = _port(D.deformConv2dPlain, x, off, m, w, b, shape[-1])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("scale,tier", [(1.8, 0), (5.8, 1), (50.0, 2)], ids=["M1", "M3", "gather"])
def test_plain_matches_jax_tiers(scale, tier):
    """deformConv2d picks its tier from max |offset|: <= 1 the M = 1
    window, <= 3 the M = 3 window, else the gather.  The port has none."""
    shape = SHAPES["dg4_16x12"]
    x, off, m, w, b = _case(2, *shape, scale=scale)
    bound = float(np.abs(off).max())
    assert (bound <= 1) if tier == 0 else (1 < bound <= 3) if tier == 1 else (bound > 3)
    B, H, W = shape[:3]
    flat = lambda a: a.reshape(B, H, W, -1)
    ref = _jax(jaxDeform.deformConv2d, x, flat(off), flat(m), w, b, shape[-1])
    np.testing.assert_allclose(_port(D.deformConv2dPlain, x, off, m, w, b, shape[-1]), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES.values())[1:], ids=list(SHAPES.keys())[1:])
def test_plain_matches_pallas_interpret(shape):
    """The TPU kernel itself (interpret mode), at its M = 3 window."""
    x, off, m, w, b = _case(3, *shape, scale=5.8)
    ref = _jax(dcnDensePallas, x, off, m, w, b, shape[-1], margin=3, interpret=True)
    np.testing.assert_allclose(_port(D.deformConv2dPlain, x, off, m, w, b, shape[-1]), ref, atol=TOL, rtol=0)


def test_plain_bf16_matches_pallas_bf16():
    """bf16 x, offsets and mask, as the card hands them, against the Pallas
    body in bf16 (interpret): the same rounding of each sampled value
    before an fp32 contraction."""
    import jax.numpy as jnp

    shape = SHAPES["dg4_16x12"]
    x, off, m, w, b = _case(4, *shape, scale=1.8)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x, off, m = bf(x), bf(off), bf(m)
    ref = np.asarray(dcnDensePallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(off, jnp.bfloat16),
                                    jnp.asarray(m, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), shape[-1],
                                    margin=1, interpret=True).astype(jnp.float32))
    got = _port(D.deformConv2dPlain, x, off, m, w, b, shape[-1], torch.bfloat16)
    err = np.abs(got - ref)
    assert np.all(err <= BF16_REL * np.abs(ref) + BF16_ABS), float(err.max())
    fp32 = _port(D.deformConv2dPlain, x, off, m, w, b, shape[-1])
    assert float(np.abs(got - fp32).max()) > 0  # the bf16 path rounds


def test_plain_huge_and_nan_offsets():
    """Offsets of 25 px and 1e6 take JAX's gather tier and agree with it;
    a NaN offset gives NaN at its output pixel, where JAX's deformConv2d
    gives NaN too (JAX then runs the whole call at its M = 1 tier, which
    truncates the finite pixels beyond 1 px: those are held against the
    gather path instead)."""
    shape = SHAPES["dg2_12x9"]
    B, H, W, dg = shape[0], shape[1], shape[2], shape[-1]
    x, off, m, w, b = _case(5, *shape, scale=5.8)
    off[0, 3, 4, 0, 2, 0] = 25.0
    off[1, 5, 1, 1, 7, 1] = -25.0
    off[0, 7, 2, 1, 0, 0] = 1e6
    off[1, 0, 8, 0, 4, :] = (-1e6, 1e6)
    flat = lambda a: a.reshape(B, H, W, -1)
    ref = _jax(jaxDeform._deformConvGather, x, off, m, w, b, dg, 1, 1)
    got = _port(D.deformConv2dPlain, x, off, m, w, b, dg)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _jax(jaxDeform.deformConv2d, x, flat(off), flat(m), w, b, dg), atol=TOL, rtol=0)

    off[0, 2, 6, 1, 3, 0] = np.nan
    off[1, 9, 0, 0, 8, 1] = np.nan
    got = _port(D.deformConv2dPlain, x, off, m, w, b, dg)
    nanRef = np.isnan(_jax(jaxDeform.deformConv2d, x, flat(off), flat(m), w, b, dg))
    np.testing.assert_array_equal(np.isnan(got), nanRef)
    assert nanRef[0, 2, 6].all() and nanRef[1, 9, 0].all() and nanRef.sum() == 2 * shape[4]
    ref = _jax(jaxDeform._deformConvGather, x, off, m, w, b, dg, 1, 1)
    np.testing.assert_allclose(got[~nanRef], ref[~nanRef], atol=TOL, rtol=0)


def test_modulated_deform_conv_pack_matches_jax():
    """The pack with weights carried across: conv_offset predicts 3 dg 9
    channels from feat, the first 2 dg 9 are read in place as offsets."""
    import jax.numpy as jnp

    rng = np.random.RandomState(6)
    B, H, W, C, dg = 2, 16, 12, 16, 4
    sd = {"p.weight": rng.randn(C, C, 3, 3) * 0.1, "p.bias": rng.randn(C) * 0.1,
          "p.conv_offset.weight": rng.randn(3 * dg * 9, C, 3, 3) * 0.3, "p.conv_offset.bias": rng.randn(3 * dg * 9)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    from moephoto_tpu.models.api import convertStateDict

    jp = {k: jnp.asarray(v) for k, v in convertStateDict(sd).items()}
    x = rng.rand(B, H, W, C).astype(np.float32)
    feat = rng.rand(B, H, W, C).astype(np.float32)
    ref = np.asarray(jaxDeform.modulatedDeformConvPack(jp, "p", jnp.asarray(x), jnp.asarray(feat), dg))
    pack = D.ModulatedDeformConvPack(C, C, dg)
    pack.load_state_dict({k[2:]: v for k, v in fromJaxParams(convertStateDict(sd)).items()}, strict=True)
    with torch.inference_mode():
        offsets = pack.conv_offset(torch.from_numpy(feat).permute(0, 3, 1, 2))[:, : 2 * dg * 9]
        got = pack(torch.from_numpy(x), torch.from_numpy(feat)).numpy()
    assert 1 < float(offsets.abs().max()) < 25  # past the M = 1 window, inside the image
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    x, off, m, w, b = _case(7, 1, 6, 10, 8, 4, 2, 3.0)
    before = D.deformConv2d.launches
    got = _port(D.deformConv2d, x, off, m, w, b, 2)
    assert D.deformConv2d.launches == before  # no kernel launched
    np.testing.assert_array_equal(got, _port(D.deformConv2dPlain, x, off, m, w, b, 2))


def test_wrapper_raises_off_cpu_without_kernel():
    """Tensors that are not on the CPU never fall back to the plain version."""
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError):
        D.deformConv2d(meta(1, 4, 4, 8), meta(1, 4, 4, 36), meta(1, 4, 4, 18), meta(8, 8, 3, 3), None, 2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version on the card: dg 2 and 8,
    C = 64 (16-byte corner loads; bf16 on the tensor cores) and C = 12
    (scalar), Cout 64, 96 and 128,
    fp32 (TF32 off) and bf16, offsets up to 40 px, 1e6 and NaN, offsets
    and mask read as strided slices of one tensor.  The sampled values
    agree bit for bit; the contraction sums in another order, so fp32
    allows 1e-4 of max(1, |plain|) and bf16 one ulp of |plain| plus 2^-8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # the tensor-core instance's tiles are 16 x 16 pixels of one image:
        # ragged tiles, less than one tile, Cout = 128; C = 128 goes to the CUDA cores
        shapes = ((2, 19, 37, 64, 64, 8), (1, 24, 40, 12, 96, 2), (3, 33, 47, 64, 64, 8), (1, 5, 7, 64, 64, 8),
                  (1, 17, 31, 64, 128, 8), (1, 17, 31, 128, 64, 8))
        for seed, (B, H, W, C, Cout, dg) in enumerate(shapes):
            x, off, m, w, b = _case(10 + seed, B, H, W, C, Cout, dg, 80.0)
            off[0, 0, 0, 0, 0] = (1e6, -1e6)
            off[0, 1, 1, 0, 1, 0] = np.nan
            for dtype in (torch.float32, torch.bfloat16):
                xt = torch.from_numpy(x).cuda().to(dtype)
                both = torch.cat([torch.from_numpy(off).reshape(B, H, W, -1),
                                  torch.from_numpy(m).reshape(B, H, W, -1)], -1).cuda().to(dtype)
                ot, mt = both[..., : 2 * dg * 9], both[..., 2 * dg * 9 :]
                wt, bt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).cuda(), torch.from_numpy(b).cuda()
                before = D.deformConv2d.launches
                got = D.deformConv2d(xt, ot, mt, wt, bt, dg).float()
                assert D.deformConv2d.launches == before + 1
                assert D.deformConv2d.lastInstance == D.pickInstance(dtype, C, Cout, dg)
                want = D.deformConv2dPlain(xt, ot, mt, wt, bt, dg).float()
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan) and nan.any()
                diff = (got - want).abs()[~nan]
                ref = want.abs()[~nan]
                tol = 1e-4 * ref.clamp_min(1.0) if dtype == torch.float32 else 2.0**-7 * ref + 2.0**-8
                assert bool((diff <= tol).all()), float(diff.max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags


# ---- what the tensor-core instance adds on the host side (all on the CPU) ----


@pytest.mark.parametrize("C,Cout", [(64, 64), (64, 96), (32, 48), (64, 128), (16, 16)])
def test_packed_taps_unpack_to_taps(C, Cout):
    """The packed block the tensor-core instance reads holds exactly the
    (9, C, Cout) taps the CUDA-core instance reads, and a lane's 8 bytes are
    the B fragment W[k][16j + 2t..][8n + g] of mma.sync.m16n8k16."""
    weight = torch.from_numpy(np.random.RandomState(C + Cout).randn(Cout, C, 3, 3).astype(np.float32))
    taps = D.prepareTaps(weight, torch.bfloat16, "cuda_core")
    assert torch.equal(taps, weight.bfloat16().permute(2, 3, 1, 0).reshape(9, C, Cout))
    packed = D.prepareTaps(weight, torch.bfloat16, "mma")
    assert packed.shape == (9, C * Cout) and packed.dtype == torch.bfloat16
    assert torch.equal(D.unpackTaps(packed, C, Cout), taps)
    frag = packed.reshape(9, C // 16, Cout // 8, 32, 4)
    k, j, n, g, t = 7, C // 16 - 1, Cout // 8 - 1, 6, 2
    rows = [16 * j + 2 * t, 16 * j + 2 * t + 1, 16 * j + 8 + 2 * t, 16 * j + 9 + 2 * t]
    assert torch.equal(frag[k, j, n, g * 4 + t], torch.stack([taps[k, r, 8 * n + g] for r in rows]))


@pytest.mark.parametrize("dtype,C,Cout,dg,aligned,want", [
    ("bfloat16", 64, 64, 8, True, "mma"),         # EDVR's DCNs: the VSR path
    ("bfloat16", 64, 96, 8, True, "mma"),
    ("bfloat16", 64, 128, 8, True, "mma"),
    ("bfloat16", 32, 48, 4, True, "mma"),
    ("bfloat16", 48, 96, 6, True, "mma"),
    ("bfloat16", 128, 64, 8, True, "cuda_core"),  # the sample buffers of C = 128 leave the weights no room
    ("bfloat16", 128, 128, 8, True, "cuda_core"),
    ("bfloat16", 64, 64, 8, False, "cuda_core"),  # x not aligned for 16-byte corner loads
    ("bfloat16", 64, 64, 16, True, "cuda_core"),  # groups of 4 channels: 8-byte corners
    ("bfloat16", 12, 20, 4, True, "cuda_core"),   # widths that are no multiples of 16
    ("bfloat16", 64, 72, 8, True, "cuda_core"),
    ("float32", 64, 64, 8, True, "cuda_core"),
])
def test_instance_choice(dtype, C, Cout, dg, aligned, want):
    assert D.pickInstance(getattr(torch, dtype), C, Cout, dg, aligned) == want
    if want == "mma":
        assert D.mmaSmemBytes(C, Cout) <= D.SMEM_LIMIT


def test_pack_keeps_prepared_taps_until_the_weight_changes():
    """ModulatedDeformConvPack's cache: the same packed taps on a second
    request, fresh ones after load_state_dict."""
    pack = D.ModulatedDeformConvPack(16, 16, 2)
    with torch.no_grad():
        pack.weight.normal_()
    build = lambda: D.prepareTaps(pack.weight, torch.bfloat16, "mma")
    first = pack._tapsCache.get((torch.bfloat16, "mma"), [pack.weight], build)
    assert pack._tapsCache.get((torch.bfloat16, "mma"), [pack.weight], build) is first
    assert pack._tapsCache.get((torch.bfloat16, "cuda_core"), [pack.weight],
                               lambda: D.prepareTaps(pack.weight, torch.bfloat16, "cuda_core")) is not first
    sd = {k: v.clone() for k, v in pack.state_dict().items()}
    sd["weight"] = sd["weight"] * 2
    pack.load_state_dict(sd)
    second = pack._tapsCache.get((torch.bfloat16, "mma"), [pack.weight], build)
    assert second is not first
    assert torch.equal(D.unpackTaps(second, 16, 16), D.unpackTaps(first, 16, 16) * 2)
