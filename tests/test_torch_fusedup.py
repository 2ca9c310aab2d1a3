"""The port's fused up-path kernel (moephoto_tpu_torch/ops/fusedup.py)
against the JAX package's Pallas kernel, run in interpret mode.

Tolerance: 1e-5 absolute in fp32.  Both sides compute fp32 products and
sums of 48- or 96-term dot products with outputs of order 1; only the
summation order differs between torch and XLA."""

import numpy as np
import pytest
import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models.api import fromJaxParams, packBlockDiag
from moephoto_tpu_torch.ops import fusedup
from moephoto_tpu_torch.synth import synthLite2Params
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _cpu():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _case(ups, pack, M, seed=3):
    # JAX is imported here, not at the top, so that the card-only test
    # below also runs where only torch is installed
    import jax.numpy as jnp

    from __graft_entry__ import _lite2Params
    from moephoto_tpu.models.api import packBlockDiag as jaxPackBlockDiag
    from moephoto_tpu.ops import fusedup as jaxFusedup

    jp = {k: np.asarray(v, np.float32) for k, v in _lite2Params(ups, seed=seed, random=True).items()}
    if pack > 1:
        jp = {k: np.asarray(v) for k, v in jaxPackBlockDiag(jp, pack).items()}
    c = 48 * pack
    rng = np.random.RandomState(ups * 10 + pack)
    res = rng.randn(M, c).astype(np.float32)
    im = rng.randn(M, c).astype(np.float32)
    nUps = int(ups).bit_length() - 1
    ref = jaxFusedup.fusedUpHeads(
        {k: jnp.asarray(v) for k, v in jp.items()},
        jnp.asarray(res), jnp.asarray(im), nUps, interpret=True,
    )
    return fromJaxParams(jp), torch.from_numpy(res), torch.from_numpy(im), nUps, np.asarray(ref)


@pytest.mark.parametrize("ups,pack", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2)])
def test_plain_matches_jax_kernel(ups, pack):
    """nUps 1/2/3, unpacked (c=48, cout=1) and packed (c=96, cout=2), with
    M a multiple of no tile size."""
    params, res, im, nUps, ref = _case(ups, pack, M=203)
    got = fusedup.fusedUpHeadsPlain(params, res, im, nUps).numpy()
    assert got.shape == ref.shape == (203, 4**nUps * pack)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    params, res, im, nUps, ref = _case(4, 1, M=37)
    before = fusedup.fusedUpHeads.launches
    got = fusedup.fusedUpHeads(params, res, im, nUps)
    assert fusedup.fusedUpHeads.launches == before  # no kernel launched
    np.testing.assert_array_equal(got.numpy(), fusedup.fusedUpHeadsPlain(params, res, im, nUps).numpy())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_wrapper_raises_off_cpu_without_kernel():
    """Rows that are not on the CPU never fall back to the plain version."""
    params = synthLite2Params(4, seed=3)
    rows = torch.empty((16, 48), device="meta")
    with pytest.raises(ValueError):
        fusedup.fusedUpHeads(params, rows, rows, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """CUDA kernel against its plain version on the card (fp32 with TF32
    off: 1e-4; bf16: 2**-6 relative + 2**-6 absolute, room for a few bf16
    roundings that fall the other way after a different fp32 sum order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(0)
    # 1001 rows and, around the tensor-core tiles (16 rows a warp, 64 a
    # warpgroup, 192 a block), ragged counts; c = 96 with nUps 1 to 3
    cases = [(ups, pack, 1001) for ups, pack in ((2, 1), (4, 1), (8, 1), (4, 2), (2, 2), (8, 2))]
    cases += [(4, 1, M) for M in (1, 15, 17, 63, 65, 191, 193, 132 * 192 + 7)] + [(8, 2, M) for M in (15, 193)]
    for ups, pack, M in cases:
        sd = synthLite2Params(ups, seed=3)
        sd = packBlockDiag(sd, pack) if pack > 1 else sd
        params = {k: v.cuda().to(dt) for k, v in sd.items()}
        res, im = (torch.from_numpy(rng.randn(M, 48 * pack).astype(np.float32)).cuda().to(dt)
                   for _ in range(2))
        nUps = int(ups).bit_length() - 1
        before = fusedup.fusedUpHeads.launches
        got = fusedup.fusedUpHeads(params, res, im, nUps).float()
        assert fusedup.fusedUpHeads.launches == before + 1
        assert fusedup.fusedUpHeads.lastInstance == fusedup.pickInstance(dt, 48 * pack, nUps, pack)
        want = fusedup.fusedUpHeadsPlain(params, res, im, nUps).float()
        tol = 1e-4 if dt == torch.float32 else 2**-6 * want.abs() + 2**-6
        assert bool(((got - want).abs() <= tol).all()), (ups, pack, M, dtype)


# ---- what the tensor-core instances add on the host side (all on the CPU) ----


def _synth(ups, pack):
    sd = synthLite2Params(ups, seed=3)
    return (packBlockDiag(sd, pack) if pack > 1 else sd), int(ups).bit_length() - 1


@pytest.mark.parametrize("ups,pack", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2)])
def test_mma_weight_block_unpacks_to_prep_weights(ups, pack):
    """The fragment-ordered bf16 block of the mma.sync instance holds
    exactly prepWeights' (4, c, c) [sub][ci][co] tensors, at c = 48 and 96;
    at c = 96, where the instance runs, ``prepare`` makes that block and an
    fp32 block of biases, slopes, head rows and the summed head bias in the
    kernel's order."""
    sd, nUps = _synth(ups, pack)
    c = 48 * pack
    res, im, hr, hi, hb = fusedup.prepWeights(sd, nUps, torch.bfloat16)
    packed = torch.stack([torch.stack([fusedup.packStageWeights(w) for w, _, _ in st]) for st in (res, im)])
    assert packed.shape == (2, nUps, 4, c * c) and packed.dtype == torch.bfloat16
    for b, stages in enumerate((res, im)):
        for k, (w, _, _) in enumerate(stages):
            assert torch.equal(fusedup.unpackStageWeights(packed[b, k], c), w)
    # a lane's 16 bytes are the B fragments of two 8-column tiles: W[16j+2t..][16 i2+g], then 8 columns on
    frag = packed[1, nUps - 1, 2].reshape(c // 16, c // 16, 32, 8)
    w = im[nUps - 1][0][2]
    j, i2, g, t = c // 16 - 1, 1, 5, 3
    rows = [16 * j + 2 * t, 16 * j + 2 * t + 1, 16 * j + 8 + 2 * t, 16 * j + 9 + 2 * t]
    want = [w[r, 16 * i2 + g] for r in rows] + [w[r, 16 * i2 + 8 + g] for r in rows]
    assert torch.equal(frag[j, i2, g * 4 + t], torch.stack(want))
    if c != fusedup.MMA_WIDTH:
        return
    prepared = fusedup.prepare(sd, nUps, torch.bfloat16, "cpu")
    assert prepared.instance == "mma" and torch.equal(prepared.tensors[0], packed)
    fblock, at = prepared.tensors[1], 0
    for stages, head in ((res, hr), (im, hi)):
        for part in [bias for _, bias, _ in stages] + [slope for _, _, slope in stages] + [head]:
            assert torch.equal(fblock[at : at + part.numel()], part.reshape(-1))
            at += part.numel()
    assert torch.equal(fblock[at : at + pack], hb) and fblock.numel() == fusedup.mmaFloatCount(c, nUps, pack)


@pytest.mark.parametrize("ups", [2, 4, 8])
def test_wgmma_weight_block_unpacks_to_prep_weights(ups):
    """The wgmma instance's block: each (64, 48) matrix holds the stage's
    weights and, in rows 48..50, its fp32 bias as three bf16 terms whose
    sum is the bias exactly; the heads' fragments hold the fp32 head rows
    the same way; the fp32 block the slopes and the summed head bias."""
    sd, nUps = _synth(ups, 1)
    prepared = fusedup.prepare(sd, nUps, torch.bfloat16, "cpu")
    assert prepared.instance == "wgmma" and prepared.slope01  # one slope a stage, 0.25
    packed, frags, fblock = prepared.tensors
    assert packed.shape == (2, nUps, 4, 64 * 48) and frags.shape == (2, 3, 32, 4)
    res, im, hr, hi, hb = fusedup.prepWeights(sd, nUps, torch.bfloat16)
    for b, (stages, head) in enumerate(((res, hr), (im, hi))):
        for k, (w, bias, slope) in enumerate(stages):
            gotW, gotB = fusedup.unpackStageWeightsWgmma(packed[b, k], 48)
            assert torch.equal(gotW, w) and torch.equal(gotB, bias)
            assert torch.equal(fblock[(b * nUps + k) * 48 : (b * nUps + k + 1) * 48], slope)
        assert torch.equal(fusedup.unpackHeadFragments(frags[b], 1), head)
    assert torch.equal(fblock[2 * nUps * 48 : 2 * nUps * 48 + 1], hb)
    # element (k, n) of a matrix lies in core matrix (k-step, k half, column block), row n % 8
    m, (w, _, _) = packed[0, 0, 3], res[0]
    for k, n in ((0, 0), (17, 5), (47, 47), (33, 40)):
        at = (k // 16) * 768 + ((k % 16) // 8) * 384 + (n // 8) * 64 + (n % 8) * 8 + k % 8
        assert m[at] == w[3, k, n]


def test_split3_is_exact():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * torch.logspace(-6, 3, 4096)
    terms = fusedup.split3(x)
    assert terms.dtype == torch.bfloat16
    assert torch.equal((terms[0].float() + terms[1].float()) + terms[2].float(), x)


@pytest.mark.parametrize("dtype,c,nUps,cout,want", [
    ("bfloat16", 48, 2, 1, "wgmma"),                # the main path: lite x4
    ("bfloat16", 48, 1, 1, "wgmma"),                # lite x2
    ("bfloat16", 48, 3, 1, "wgmma"),                # lite x8
    ("bfloat16", 48, 2, 2, "wgmma"),
    ("bfloat16", 48, 2, 3, "cuda_core"),            # the wgmma instance's heads take two planes
    ("bfloat16", 96, 1, 2, "mma_weights_in_smem"),  # packed x2
    ("bfloat16", 96, 2, 2, "mma_weights_from_l1"),  # 295 KB of weights
    ("bfloat16", 96, 3, 2, "mma_weights_from_l1"),
    ("bfloat16", 48, 3, 4, "cuda_core"),            # 256 output columns a row: the tiles do not fit
    ("bfloat16", 20, 2, 1, "cuda_core"),            # no multiple of 16
    ("bfloat16", 64, 2, 1, "cuda_core"),            # a width the tensor-core instances are not built for
    ("bfloat16", 96, 1, 4, "mma_weights_in_smem"),
    ("float32", 48, 2, 1, "cuda_core"),
    ("float32", 96, 1, 2, "cuda_core"),
])
def test_instance_choice(dtype, c, nUps, cout, want):
    picked = fusedup.pickInstance(getattr(torch, dtype), c, nUps, cout)
    assert fusedup.instanceVariant(picked, c, nUps, cout) == want
    if picked != "cuda_core":
        assert fusedup.tensorSmemBytes(picked, c, nUps, cout, want != "mma_weights_from_l1") <= fusedup.SMEM_LIMIT


def test_prepare_refuses_an_instance_that_does_not_fit():
    sd, nUps = _synth(4, 2)
    with pytest.raises(ValueError, match="no wgmma instance"):
        fusedup.prepare(sd, nUps, torch.bfloat16, "cpu", instance="wgmma")
    assert fusedup.prepare(sd, nUps, torch.float32, "cpu").instance == "cuda_core"
    with pytest.raises(ValueError, match="no mma instance"):
        fusedup.prepare(sd, nUps, torch.float32, "cpu", instance="mma")


def test_module_weight_cache():
    """MoeNetLite2 keeps what the kernel reads per (dtype, device): the
    same object on a second call; a fresh one after load_state_dict, after
    an in-place write to a parameter and after a cast of the module."""
    from moephoto_tpu_torch.models.sr import MoeNetLite2

    model = MoeNetLite2(4)
    model.load_state_dict(synthLite2Params(4, seed=3))
    first = model.upWeights(torch.float32, "cpu")
    assert model.upWeights(torch.float32, "cpu") is first
    assert model.upWeights(torch.bfloat16, "cpu") is not first  # its own entry
    assert model.upWeights(torch.float32, "cpu") is first
    model.load_state_dict(synthLite2Params(4, seed=4))
    second = model.upWeights(torch.float32, "cpu")
    assert second is not first
    want = fusedup.prepWeights(dict(model.named_parameters()), 2, torch.float32)[0][0][0]
    assert torch.equal(second.tensors[0][0], want)  # made from the new weights
    with torch.no_grad():
        model.uim[1][0].weight.mul_(0.5)
    third = model.upWeights(torch.float32, "cpu")
    assert third is not second and model.upWeights(torch.float32, "cpu") is third
    model.to(torch.bfloat16)
    assert model.upWeights(torch.float32, "cpu") is not third
    x = torch.rand(1, 8, 8, 1)
    with torch.inference_mode():  # the forward goes through the cache
        got = MoeNetLite2(4).float()(x)
    assert got.shape == (1, 32, 32, 1)


@pytest.mark.parametrize("ups,pack", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_plain_bf16_within_kernel_tolerance_of_fp32(ups, pack):
    """The tolerance the card check holds the bf16 kernels to, 2**-6 *
    |ref| + 2**-6: the plain version in bf16 (one rounding a stage) stays
    within it of itself in fp32 on the same bf16-valued inputs."""
    sd, nUps = _synth(ups, pack)
    rng = np.random.RandomState(ups + pack)
    rows = [torch.from_numpy(rng.randn(2000, 48 * pack).astype(np.float32)).bfloat16() for _ in range(2)]
    low = {k: v.bfloat16() for k, v in sd.items()}
    got = fusedup.fusedUpHeadsPlain(low, rows[0], rows[1], nUps).float()
    ref = fusedup.fusedUpHeadsPlain({k: v.float() for k, v in low.items()}, rows[0].float(), rows[1].float(), nUps)
    err = (got - ref).abs()
    assert bool((err <= 2.0**-6 * ref.abs() + 2.0**-6).all()), float(err.max())
    assert float(err.max()) > 0  # bf16 does round
