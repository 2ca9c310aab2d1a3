"""The JAX package's space-to-depth NetDN (``moephoto_tpu/models/s2d.py``
through ``models/sr.py`` ``netDNS2d``) against the port's NetDN: s2d is a
layout for the TPU's 128-lane matrix unit that leaves the function as it
is (``moephoto_tpu/pipeline/registry.py:206`` takes it only on a TPU), so
the port computes what it computes without porting it.  The shapes and the
3e-4 tolerance of ``tests/test_s2d.py:81-105`` (fp32 summation order over
the 14-conv chain), plain and with pack = 2 (the port's ``packBlockDiag``;
its NetDN runs the packed weights through ``torch.func.functional_call``).
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.models import api as JA
from moephoto_tpu_torch.models.api import packBlockDiag
from moephoto_tpu_torch.models.sr import NetDN
from moephoto_tpu_torch.synth import synthNetDNParams
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)


@pytest.mark.parametrize("pack", [1, 2])
def test_port_netdn_equals_jax_s2d_netdn(pack):
    import jax.numpy as jnp

    from moephoto_tpu.models.sr import netDNS2d, netDNS2dParams

    sd = synthNetDNParams(2 + pack)
    if pack > 1:
        sd = packBlockDiag(sd, pack)
    x = (np.random.RandomState(pack).rand(2, 32, 40, pack).astype(np.float32) - 0.5) * 0.3
    with torch.inference_mode():
        got = torch.func.functional_call(NetDN().eval(), sd, (torch.from_numpy(x),)).numpy()
    jp = {k: jnp.asarray(v) for k, v in JA.convertStateDict({k: v.numpy() for k, v in sd.items()}).items()}
    ref = np.asarray(netDNS2d(netDNS2dParams(jp), jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 32, 40, pack) and got.std() > 1e-3
    np.testing.assert_allclose(got, ref, atol=3e-4)
