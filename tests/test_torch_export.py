"""The port's model export (moephoto_tpu_torch/tools/export.py) on the
CPU: lite x2 (the fused module, whose K1 runs its plain version here),
AiLUT tpami and AOD exported through the registry with ``torch.export``,
saved, loaded with ``loadExported`` and held bit-equal to the eager port
and against the JAX package's functions on the same weights (carried by
fromJaxParams), one of them also through ``jax.export``'s round trip as
the JAX tool (tools/export_stablehlo.py:36-38) does it; the fakes of the
K1 and K4/K5 ops on meta tensors; the CLI's line and its refusal of an
unknown model.

Tolerance against JAX: 2e-5 * max(1, |ref|) in fp32, the sum orders of
torch and XLA differing (lite: eight conv/matmul layers of up to
432-term sums; AOD: five convs; AiLUT: a backbone of up to 1152-term sums
whose codes move the LUT a little).  AiLUT's input lies in [0, 1], the
image range the registry's AiLUT entry sees; its extrapolation past the
vertex range is held in tests/test_torch_retouch_models.py.
"""

import os

import numpy as np
import pytest
import torch

from __graft_entry__ import _lite2Params
from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.models import ailut as jaxAilut
from moephoto_tpu.models import sr as jaxSr
from moephoto_tpu.models.api import convertStateDict
from moephoto_tpu.models.restore import aodNet as jaxAod
from moephoto_tpu.ops import fusedup as jaxFusedup
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.ops import fusedup, lut
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.synth import synthAiLUTParams, synthAODParams, synthLite2Params
from moephoto_tpu_torch.tools import export
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

TOL = 2e-5


def _liteJax(x):
    import jax.numpy as jnp

    params = {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in _lite2Params(2, seed=3, random=True).items()}
    orig = jaxFusedup.fusedUpHeads
    jaxFusedup.fusedUpHeads = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        return np.asarray(jaxSr.makeMoeNetLite2(2, fused=True)(params, jnp.asarray(x)))
    finally:
        jaxFusedup.fusedUpHeads = orig


def _liteWeights():
    return fromJaxParams({k: np.asarray(v) for k, v in _lite2Params(2, seed=3, random=True).items()})


def _carried(sd):
    """JAX params in the JAX layout and the port's dict carried back."""
    jp = convertStateDict({k: v.numpy() for k, v in sd.items()})
    return jp, fromJaxParams(jp)


def _jaxCall(fn, jp, x):
    import jax.numpy as jnp

    return np.asarray(fn({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x)))


# registry key -> (checkpoint path under modelDir, input (h, w, c))
CASES = {"lite2": ("lite/model.pth", (32, 48, 1)), "AiLUT_sRGB_3": ("AiLUT/AiLUT-FiveK-sRGB.pth", (64, 64, 3)),
         "dehaze": ("dehaze/AOD_net_epoch_relu_10.pth", (64, 64, 3))}


def _weightsAndReference(name):
    """(the port's state dict, the JAX function of an NHWC batch) on the same weights."""
    if name == "lite2":
        return _liteWeights(), _liteJax
    sd, fn = (synthAiLUTParams("tpami", 3, 7), jaxAilut.ailutTPAMI) if name == "AiLUT_sRGB_3" else \
        (synthAODParams(6), jaxAod)
    jp, back = _carried(sd)
    return back, lambda x: _jaxCall(fn, jp, x)


@pytest.fixture
def modelDir(tmp_path):
    """The port on the CPU with an empty modelDir; the registry's caches
    cleared before and after, the config restored."""
    saved = (config.device, config.modelDir, jaxConfig.modelDir)
    caches = (registry._modelCache, registry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir = "cpu", str(tmp_path)
    yield tmp_path
    config.device, config.modelDir, jaxConfig.modelDir = saved
    for c in caches:
        c.clear()


def _write(modelDir, rel, sd):
    path = os.path.join(str(modelDir), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exported_program_is_eager_and_matches_jax(modelDir, name):
    rel, (h, w, c) = CASES[name]
    sd, jaxFn = _weightsAndReference(name)
    _write(modelDir, rel, sd)
    _, out = export.exportModel(name, str(modelDir / f"{name}.pt2"), h, w)
    program = export.loadExported(out)
    x = np.random.RandomState(5).rand(1, h, w, c).astype(np.float32)
    got = program(torch.from_numpy(x))
    ex = registry.buildExec(export.lookup(name))
    with torch.no_grad():
        eager = export.Program(ex.model, ex.dtype)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and torch.equal(got, eager)
    ref = jaxFn(x)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref)
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(ref))), float(err.max())


def test_lite_export_traces_the_plain_up_path_on_the_cpu(modelDir):
    """On the CPU the fused module's up path is its plain version over the
    module's own parameters: no op node, no constant, and the up
    weights are parameters of the program."""
    _write(modelDir, "lite/model.pth", synthLite2Params(2, 0))
    exported, _ = export.exportModel("lite2", str(modelDir / "lite2.pt2"), 16, 24)
    targets = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert not any("moephoto_torch" in t for t in targets)
    assert not exported.constants
    assert {"model.ures.0.0.weight", "model.convt_R1.weight"} <= set(exported.state_dict)


def test_aod_program_matches_jax_export_round_trip(modelDir):
    """The JAX tool's path for AOD: jax.export of the jitted function,
    serialized, deserialized and called; against the port's loaded program."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    rel, (h, w, c) = CASES["dehaze"]
    jp, back = _carried(synthAODParams(6))
    _write(modelDir, rel, back)
    _, out = export.exportModel("dehaze", str(modelDir / "dehaze.pt2"), h, w)
    p = {k: jnp.asarray(v) for k, v in jp.items()}
    x = np.random.RandomState(8).rand(1, h, w, c).astype(np.float32)
    fn = jax.jit(lambda v: jaxAod(p, v.astype(jnp.float32)).astype(jnp.float32))
    blob = jexport.export(fn)(jnp.zeros((1, h, w, c), jnp.float32)).serialize()
    ref = np.asarray(jexport.deserialize(blob).call(jnp.asarray(x)))
    got = export.loadExported(out)(torch.from_numpy(x)).numpy()
    err = np.abs(got - ref)
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(ref))), float(err.max())


@pytest.mark.parametrize("instance,pack,nUps,dtype", [("wgmma", 1, 2, torch.bfloat16), ("mma", 2, 1, torch.bfloat16),
                                                      ("cuda_core", 1, 3, torch.float32),
                                                      ("cuda_core", 2, 2, torch.bfloat16)])
def test_fused_up_heads_fake_on_meta(instance, pack, nUps, dtype):
    """The K1 op's fake gives (M, 4**nUps * cout) in the rows' dtype for
    each instance's prepared weights, on meta tensors."""
    from moephoto_tpu_torch.models.api import packBlockDiag

    sd = synthLite2Params(2**nUps, seed=1)
    sd = packBlockDiag(sd, pack) if pack > 1 else sd
    up = fusedup.prepare(sd, nUps, dtype, "cpu", instance)
    assert up.instance == instance
    M, c = 37, 48 * pack
    rows = torch.empty((M, c), dtype=dtype, device="meta")
    out = torch.ops.moephoto_torch.fused_up_heads(rows, rows, [t.to("meta") for t in up.tensors], nUps, up.cout,
                                                  up.instance, up.slope01)
    assert out.device.type == "meta" and out.dtype == dtype and out.shape == (M, 4**nUps * pack)


@pytest.mark.parametrize("op", ["ailut_transform", "ailut_transform_clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ailut_fakes_on_meta(op, dtype):
    img = torch.empty((2, 7, 9, 3), dtype=dtype, device="meta")
    table = torch.empty((2, 3, 17, 17, 17), device="meta")
    vertices = torch.empty((2, 3, 17), device="meta")
    out = getattr(torch.ops.moephoto_torch, op)(img, table, vertices)
    assert out.device.type == "meta" and out.dtype == dtype and out.shape == img.shape
    assert lut._OPS  # both ops registered by the module


def test_ops_are_cuda_only():
    """On CPU tensors the ops have no kernel: the wrappers take the plain
    versions there before reaching them."""
    rows = torch.zeros((4, 48))
    with pytest.raises(NotImplementedError):
        torch.ops.moephoto_torch.fused_up_heads(rows, rows, [], 1, 1, "cuda_core", False)
    with pytest.raises(NotImplementedError):
        torch.ops.moephoto_torch.ailut_transform(torch.zeros((1, 2, 2, 3)), torch.zeros((1, 3, 2, 2, 2)),
                                                 torch.zeros((1, 3, 2)))


def test_cli_writes_the_file_and_prints_the_jax_line(modelDir, capsys):
    _write(modelDir, "lite/model.pth", synthLite2Params(2, 0))
    out = str(modelDir / "x.pt2")
    assert export.main(["lite2", out, "16", "24"]) == out
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"exported lite2 -> {out} ({os.path.getsize(out)} bytes)"
    assert export.loadExported(out)(torch.zeros((1, 16, 24, 1))).shape == (1, 32, 48, 1)


def test_cli_refuses_an_unknown_model(modelDir):
    with pytest.raises(SystemExit, match="unknown model nope"):
        export.main(["nope"])
