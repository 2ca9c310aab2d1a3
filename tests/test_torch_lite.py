"""The port's MoeNetLite2 (moephoto_tpu_torch/models/sr.py) against the
JAX package's makeMoeNetLite2, plain and fused (Pallas in interpret
mode), with the same seeded weights carried by fromJaxParams.

Tolerance: 2e-5 absolute in fp32: eight conv/matmul layers of up to
432-term fp32 sums whose order differs between torch and XLA."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _lite2Params
from moephoto_tpu.models import sr as jaxSr
from moephoto_tpu.models.api import packBlockDiag as jaxPackBlockDiag
from moephoto_tpu.ops import fusedup as jaxFusedup
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models.api import fromJaxParams, packBlockDiag
from moephoto_tpu_torch.models.sr import MoeNetLite2
from moephoto_tpu_torch.synth import synthLite2Params
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _jaxParams(ups, pack=1):
    import jax.numpy as jnp

    jp = {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in _lite2Params(ups, seed=3, random=True).items()}
    return jaxPackBlockDiag(jp, pack) if pack > 1 else jp


def _jaxRun(ups, params, x, fused):
    import jax.numpy as jnp

    if not fused:
        return np.asarray(jaxSr.makeMoeNetLite2(ups)(params, jnp.asarray(x)))
    orig = jaxFusedup.fusedUpHeads
    jaxFusedup.fusedUpHeads = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        return np.asarray(jaxSr.makeMoeNetLite2(ups, fused=True)(params, jnp.asarray(x)))
    finally:
        jaxFusedup.fusedUpHeads = orig


def _portRun(ups, sd, x, fused, pack=1):
    model = MoeNetLite2(ups, pack=pack, fused=fused)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("ups", [2, 4, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_lite_matches_jax(ups, fused):
    params = _jaxParams(ups)
    x = np.random.RandomState(ups).rand(2, 16, 16, 1).astype(np.float32)
    ref = _jaxRun(ups, params, x, fused)
    got = _portRun(ups, fromJaxParams({k: np.asarray(v) for k, v in params.items()}), x, fused)
    assert got.shape == ref.shape == (2, 16 * ups, 16 * ups, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_lite_packed_matches_jax():
    """Plane-packed (pack=2, block-diagonal 96-channel weights)."""
    params = _jaxParams(4, pack=2)
    x = np.random.RandomState(7).rand(1, 16, 16, 2).astype(np.float32)
    ref = _jaxRun(4, params, x, fused=True)
    got = _portRun(4, fromJaxParams({k: np.asarray(v) for k, v in params.items()}), x, True, pack=2)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ups", [2, 4, 8])
def test_synth_params_load_strict_and_match_jax_draws(ups):
    """synthLite2Params gives the JAX random lite weights, in torch
    layout, and the module takes them with strict=True."""
    sd = synthLite2Params(ups, seed=3)
    carried = fromJaxParams({k: np.asarray(v) for k, v in _lite2Params(ups, seed=3, random=True).items()})
    assert sd.keys() == carried.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), carried[k].numpy(), err_msg=k)
    model = MoeNetLite2(ups)
    model.load_state_dict(sd, strict=True)
    packed = MoeNetLite2(ups, pack=2)
    packed.load_state_dict(packBlockDiag(sd, 2), strict=True)
