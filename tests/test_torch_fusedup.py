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
    for ups, pack in ((2, 1), (4, 1), (8, 1), (4, 2)):
        sd = synthLite2Params(ups, seed=3)
        sd = packBlockDiag(sd, pack) if pack > 1 else sd
        params = {k: v.cuda().to(dt) for k, v in sd.items()}
        res, im = (torch.from_numpy(rng.randn(1001, 48 * pack).astype(np.float32)).cuda().to(dt)
                   for _ in range(2))
        nUps = int(ups).bit_length() - 1
        before = fusedup.fusedUpHeads.launches
        got = fusedup.fusedUpHeads(params, res, im, nUps).float()
        assert fusedup.fusedUpHeads.launches == before + 1
        want = fusedup.fusedUpHeadsPlain(params, res, im, nUps).float()
        tol = 1e-4 if dt == torch.float32 else 2**-6 * want.abs() + 2**-6
        assert bool(((got - want).abs() <= tol).all()), (ups, pack, dtype)
