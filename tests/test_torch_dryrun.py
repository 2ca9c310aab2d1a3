"""The port's multi-device dry run (moephoto_tpu_torch/tools/dryrun.py
``dryrunMultichip``) against the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:92``) on ``cpu`` x n.

The output shapes are those of the JAX line, from ``__graft_entry__.py``'s
shape arithmetic (running JAX's whole dry run, IconVSR at 30 blocks
included, would take most of a minute); the loss is the JAX package's
``makeShardedTrainStep`` loss on the dry run's own seeded inputs, within
1e-6 relative (fp32, JAX at precision ``highest``)."""

import math

import numpy as np
import pytest
import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.parallel import mesh as M
from moephoto_tpu_torch.tools import dryrun as D
from moephoto_tpu_torch.tools.dryrun import dryrunMultichip
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)


def _jaxShapes(n):
    """``dryrun_multichip(n)``'s shapes, as ``__graft_entry__.py`` makes
    them: the lite x2 forward of (dp 2, sp 24, 32, 1), IconVSR x4 of 3
    frames of lcm(64, n) x 64, ESTRNN and IFRNet-S on max(64, 4 n) x 64."""
    dp = 2 if n % 2 == 0 else 1
    sp = n // dp
    vH, eH = math.lcm(64, n), max(64, 4 * n)
    return dict(infer=(dp * 2, sp * 24 * 2, 64, 1), video=(3, 4 * vH, 4 * 64, 3), estrnn=(2, eH, 64, 3),
                ifrnet=(2, 1, eH, 64, 3))


def _jaxLoss(n):
    """The JAX package's sharded SGD step on the dry run's inputs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as GE
    from moephoto_tpu.models.sr import moeNetLite2x2
    from moephoto_tpu.parallel.mesh import makeMesh
    from moephoto_tpu.parallel.sharded import makeShardedTrainStep

    dp = 2 if n % 2 == 0 else 1
    sp = n // dp
    mesh = makeMesh([dp, sp], ("dp", "sp"), jax.devices("cpu")[:n])
    rng = np.random.RandomState(0)
    x = rng.rand(dp * 2, sp * 32, 64, 1).astype(np.float32)
    y = rng.rand(dp * 2, sp * 64, 128, 1).astype(np.float32)
    sh = NamedSharding(mesh, P("dp", "sp", None, None))
    with mesh:
        _, loss = makeShardedTrainStep(moeNetLite2x2, mesh, halo=8, scale=2, lr=1e-4)(
            GE._lite2Params(2), jax.device_put(x, sh), jax.device_put(y, sh))
    return float(loss)


@pytest.mark.parametrize("n", [8, 6])
def test_dryrun_prints_the_jax_line(n, capsys):
    """``dryrunMultichip(n)`` on ``cpu`` x n prints the JAX line with its
    shapes and loss, and leaves no mesh and the config's device as it
    found them; the line ends with the mesh's devices."""
    device = config.device
    line = dryrunMultichip(n, ["cpu"] * n)
    assert capsys.readouterr().out == line + "\n"
    shapes = _jaxShapes(n)
    want = (f"dryrun_multichip({n}): loss=... infer={shapes['infer']} video={shapes['video']} "
            f"estrnn={shapes['estrnn']} ifrnet={shapes['ifrnet']} devices=cpu*{n}")
    head, _, tail = line.partition(" infer=")
    assert f"{head.split(' loss=')[0]} loss=... infer={tail}" == want
    loss = float(head.rsplit("=", 1)[1])
    ref = _jaxLoss(n)
    assert abs(loss - ref) <= max(1e-6 * ref, 5e-6), (loss, ref)  # the line prints 5 decimals
    assert M.activeMesh() is None and config.device == device


def test_dryrun_takes_n_devices():
    with pytest.raises(ValueError, match="3 devices for a mesh of 4"):
        dryrunMultichip(4, ["cpu"] * 3)


def test_dryrun_takes_the_cards_unless_the_cpu_is_asked(monkeypatch):
    """Given no devices the mesh is the CUDA cards (``cuda:0`` x n on
    fewer than n), and without a card the dry run stops; the command line
    takes ``cpu`` x n only with ``--backend cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrunMultichip(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, ["cuda:0"] * 8), (8, [f"cuda:{i}" for i in range(8)])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert [str(d) for d in D.cardsFor(8)] == want
    assert D.describe(["cuda:0"] * 8) == "cuda:0*8" and D.describe(["cuda:0", "cuda:1"]) == "cuda:0,cuda:1"
    calls = []
    monkeypatch.setattr(D, "dryrunMultichip", lambda n, devices=None: calls.append((n, devices)))
    D.main([])
    D.main(["6", "--backend", "cpu"])
    assert calls == [(8, None), (6, ["cpu"] * 6)]

