"""The port's multi-device serving layer (moephoto_tpu_torch/parallel/, the
tiled engine and executor on a mesh) against the JAX package's on its 8
virtual CPU devices: the halo exchange, the (dp, sp) sharded forward,
``ModelExec`` under ``config.meshShape`` and the step pipeline.  The port's
mesh is ``cpu`` x 8 (``config.meshShape`` with ``config.device = "cpu"``),
the counterpart of XLA's forced host device count."""

import contextlib
import io
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.parallel import mesh as jaxMesh
from moephoto_tpu.parallel import sharded as jaxSharded
from moephoto_tpu.parallel import temporal as jaxTemporal
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.parallel import mesh as M
from moephoto_tpu_torch.parallel import sharded as S
from moephoto_tpu_torch.parallel import temporal as T
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@contextlib.contextmanager
def jaxCpuMesh(shape):
    """The JAX package's mesh from ``config.meshShape`` on its virtual CPU
    devices, caches reset, the config restored after (as
    ``tests/test_parallel.py`` ``_withCpuMesh`` does)."""
    old = (jaxConfig.meshShape, getattr(jaxConfig, "meshBackend", ""))
    jaxConfig.meshShape, jaxConfig.meshBackend = list(shape), "cpu" if shape else ""
    jaxMesh._activeMesh[:] = [None, None]
    jaxTemporal._videoMesh[:] = [None, None]
    try:
        if shape:
            m = jaxMesh.activeMesh()
            assert m is not None and m.devices.size == int(np.prod(shape)), m
        yield
    finally:
        jaxConfig.meshShape, jaxConfig.meshBackend = old
        jaxMesh._activeMesh[:] = [None, None]
        jaxTemporal._videoMesh[:] = [None, None]


@contextlib.contextmanager
def portCpuMesh(shape):
    """The port's mesh from ``config.meshShape`` with ``config.device =
    "cpu"``, asserted real; both restored after."""
    old = (config.meshShape, config.device)
    config.meshShape, config.device = list(shape), "cpu"
    M._activeMesh[:] = [None, None]
    T._videoMesh[:] = [None, None]
    try:
        if shape:
            m = M.activeMesh()
            assert m is not None and m.size == int(np.prod(shape)) and m.flat == [CPU] * m.size, m
        yield
    finally:
        config.meshShape, config.device = old
        M._activeMesh[:] = [None, None]
        T._videoMesh[:] = [None, None]


def _jaxDevices():
    import jax

    devs = jax.devices("cpu")
    assert len(devs) >= 8, "tests/conftest.py forces 8 host devices"
    return devs[:8]


@pytest.mark.parametrize("mode", ["reflect", "edge", "zero"])
def test_halo_exchange_equals_jax_shard_map(mode):
    """Each row shard padded by ``haloExchange`` equals the JAX package's
    ``haloExchange`` inside ``shard_map`` on 8 devices, exactly, global
    edges included."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    x = np.random.RandomState(0).rand(2, 64, 12, 3).astype(np.float32)
    halo = 3
    mesh = jaxMesh.makeMesh([8], ("sp",), _jaxDevices())
    fn = jax.shard_map(lambda a: jaxSharded.haloExchange(a, halo, "sp", mode), mesh=mesh,
                       in_specs=P(None, "sp"), out_specs=P(None, "sp"), check_vma=False)
    ref = np.asarray(fn(jnp.asarray(x)))
    shards = S.RowShards.split(torch.from_numpy(x), [CPU] * 8, 1)
    got = torch.cat(S.haloExchange(shards, halo, mode), 1).numpy()
    assert got.shape == ref.shape == (2, 64 + 8 * 2 * halo, 12, 3)
    np.testing.assert_array_equal(got, ref)


def test_halo_exchange_spans_several_shards():
    """A halo longer than a shard takes rows from as many shards as it
    spans (uneven shards): every padded shard is the reflect-padded whole
    tensor's rows."""
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 40, 5, 2).astype(np.float32))
    shards = S.RowShards.split(x, [CPU] * 6, 1, 4)
    assert shards.bounds == (0, 8, 16, 24, 32, 36, 40)
    halo = 9
    full = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 0, halo, halo), mode="reflect").permute(0, 2, 3, 1)
    for j, padded in enumerate(S.haloExchange(shards, halo, "reflect")):
        a, b = shards.rowsOf(j)
        assert torch.equal(padded, full[:, a : b + 2 * halo])


def _blurJax(params, x):
    import jax
    import jax.numpy as jnp

    c = x.shape[-1]
    k = jnp.ones((3, 3, 1, c), x.dtype) / 9.0
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape, ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(x, k, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn,
                                        feature_group_count=c)


def _blurPort(x):
    c = x.shape[-1]
    k = torch.ones((c, 1, 3, 3), dtype=x.dtype) / 9.0
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=c).permute(0, 2, 3, 1)


def test_sharded_tiled_forward_blur_equals_jax():
    """The depthwise blur of ``tests/test_parallel.py`` through
    ``shardedTiledForward`` on a [2, 4] mesh: equal to the JAX package's
    sharded forward (atol 1e-5), and to the port's single-device blur in
    the interior rows (the global edges take reflect halos there)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = np.random.RandomState(0).rand(2, 32, 16, 4).astype(np.float32)
    jm = jaxMesh.makeMesh([2, 4], ("dp", "sp"), _jaxDevices())
    fwd = jaxSharded.shardedTiledForward(_blurJax, jm, halo=4, scale=1)
    with jm:
        ref = np.asarray(jax.jit(fwd)({}, jax.device_put(x, NamedSharding(jm, P("dp", "sp", None, None)))))
    mesh = M.makeMesh([2, 4], ("dp", "sp"), [CPU] * 8)
    got = S.shardedTiledForward(_blurPort, mesh, halo=4, scale=1)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    single = _blurPort(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:, 1:-1], single[:, 1:-1], atol=1e-5, rtol=0)


def test_row_bounds_are_aligned_and_even():
    assert S.rowBounds(1088, 8, 16) == [0, 144, 288, 432, 576, 704, 832, 960, 1088]
    assert S.rowBounds(1088, 2, 16) == [0, 544, 1088]
    assert S.rowBounds(64, 8, 16) == [0, 16, 32, 48, 64]  # fewer blocks than devices: fewer shards
    with pytest.raises(ValueError):
        S.rowBounds(100, 4, 16)


def test_video_mesh_flattens_and_caches():
    with portCpuMesh([2, 4]):
        vm = T.videoMesh()
        assert vm.shape == (8,) and vm.axisNames == ("sp",) and vm is T.videoMesh()
    with portCpuMesh([]):
        assert M.activeMesh() is None and T.videoMesh() is None


def test_mesh_off_config_device_platform_raises():
    """A mesh lies on ``config.device``'s platform: installing a CPU mesh
    while the card is asked for raises instead of moving the card's work
    to the CPU, and ``config.meshShape`` under ``device = "cpu"`` gives CPU
    entries."""
    old = (config.meshShape, config.device)
    try:
        config.device = "cuda"
        with pytest.raises(ValueError, match="platform"):
            M.installMesh(M.makeMesh([8], devices=[CPU] * 8))
        config.meshShape, config.device = [4], "cpu"
        M._activeMesh[:] = [None, None]
        assert M.activeMesh().flat == [CPU] * 4
    finally:
        config.meshShape, config.device = old
        M._activeMesh[:] = [None, None]


def test_replica_on_another_device_is_made_once_and_renewed_after_a_write():
    """A module's copy for a mesh device: the module itself where its
    weights lie, one copy per other device, and a new one after a write to
    the weights."""
    conv = torch.nn.Conv2d(2, 2, 3)
    assert M.replicaOn(conv, "cpu") is conv
    copy = M.replicaOn(conv, "meta")
    assert copy is not conv and copy.weight.device.type == "meta" and M.replicaOn(conv, "meta") is copy
    with torch.no_grad():
        conv.weight.add_(1.0)
    assert M.replicaOn(conv, "meta") is not copy


def test_active_mesh_with_too_few_devices_warns_as_jax(caplog):
    """An unmet ``meshShape`` logs the JAX package's warning and runs
    single-device (None), in both packages; with ``config.device = "cuda"``
    the port's mesh takes CUDA cards, of which this machine has fewer than
    asked."""
    have = torch.cuda.device_count()
    n = max(2, have + 1)
    old = (config.meshShape, config.device)
    with caplog.at_level(logging.WARNING, logger="Moe"):
        try:
            config.meshShape, config.device = [n], "cuda"
            M._activeMesh[:] = [None, None]
            assert M.activeMesh() is None
        finally:
            config.meshShape, config.device = old
            M._activeMesh[:] = [None, None]
        port = [r.getMessage() for r in caplog.records]
        caplog.clear()
        old = (jaxConfig.meshShape, jaxConfig.meshBackend)
        try:
            jaxConfig.meshShape, jaxConfig.meshBackend = [16], "cpu"
            jaxMesh._activeMesh[:] = [None, None]
            assert jaxMesh.activeMesh() is None
        finally:
            jaxConfig.meshShape, jaxConfig.meshBackend = old
            jaxMesh._activeMesh[:] = [None, None]
        ref = [r.getMessage() for r in caplog.records]
    assert port == [f"meshShape ({n},) needs {n} devices, have {have} — running single-device"]
    assert ref == ["meshShape (16,) needs 16 devices, have 8 — running single-device"]


def _lite2(seed=0):
    from moephoto_tpu_torch.models.sr import moeNetLite2x2
    from moephoto_tpu_torch.synth import synthLite2Params

    model = moeNetLite2x2()
    model.load_state_dict(synthLite2Params(2, seed))
    return model.eval()


def test_model_exec_on_mesh_matches_single_and_jax():
    """lite x2 at TileSpec(64, 4, 8, 2.0, 2) on a 150x140 plane: the runs
    under meshShape [], [8] and [2, 4] agree (atol 1e-6, as the JAX
    package's test), the [8] run matches the JAX package's run on its [8]
    mesh, and every mesh slot ran model calls of the single-device shape."""
    import jax.numpy as jnp

    import __graft_entry__ as GE
    from moephoto_tpu.engine.executor import ModelExec as JaxExec
    from moephoto_tpu.engine.tiling import TileSpec as JaxSpec
    from moephoto_tpu.models.sr import moeNetLite2x2 as jaxLite2
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.engine.tiling import TileSpec

    img = np.random.RandomState(0).rand(150, 140, 1).astype(np.float32)
    ex = ModelExec(_lite2(), TileSpec(64, 4, 8, 2.0, 2), dtype=torch.float32, name="t", device="cpu")
    shapes = []
    ex.model.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
    outs = {}
    for shape in ([], [8], [2, 4]):
        with portCpuMesh(shape):
            S.resetStats()
            outs[str(shape)] = ex(img).numpy()
            if shape:
                calls = S.stats["tileCalls"]
                # 9 tiles in one chunk of up to 2 x 8: five slots take a call each
                assert calls == {0: 1, 1: 1, 2: 1, 3: 1, 4: 1}, calls
    assert outs["[]"].shape == (300, 280, 1)
    np.testing.assert_allclose(outs["[8]"], outs["[]"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(outs["[2, 4]"], outs["[]"], atol=1e-6, rtol=0)
    assert set(shapes) == {(2, 64, 64, 1)}
    with jaxCpuMesh([8]):
        jex = JaxExec(jaxLite2, GE._lite2Params(2, seed=0), JaxSpec(64, 4, 8, 2.0, 2), dtype=jnp.float32, name="t")
        ref = np.asarray(jex(img))
    np.testing.assert_allclose(outs["[8]"], ref, atol=2e-5, rtol=0)


def test_step_pipeline_on_mesh_gives_the_same_png(tmp_path, monkeypatch):
    """file -> SR lite x2 -> output through the port's genProcess, with and
    without a [8] mesh, on synthetic weights: equal PNGs."""
    from moephoto_tpu_torch.pipeline import registry
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.runtime.context import context
    from moephoto_tpu_torch.synth import synthLite2Params

    (tmp_path / "lite").mkdir()
    torch.save(synthLite2Params(2, 0), str(tmp_path / "lite" / "model.pth"))
    monkeypatch.setattr(config, "modelDir", str(tmp_path))
    monkeypatch.setattr(config, "device", "cpu")
    registry._modelCache.clear()
    registry._paramsCache.clear()
    monkeypatch.setattr(context, "imageMode", "RGB")
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (40, 32, 3), np.uint8)).save(buf, format="PNG")
    data = buf.getvalue()
    monkeypatch.setattr(context, "sharedView", memoryview(data))

    def run(name):
        out = str(tmp_path / name)
        process, _ = genProcess([{"op": "file"}, {"op": "SR", "model": "lite", "scale": 2}, {"op": "output", "file": out}])
        process(len(data), name=out)
        return np.array(Image.open(out))

    try:
        with portCpuMesh([]):
            single = run("s.png")
        with portCpuMesh([8]):
            S.resetStats()
            multi = run("m.png")
            assert sum(S.stats["tileCalls"].values()) > 0
    finally:
        registry._modelCache.clear()
        registry._paramsCache.clear()
    assert single.shape == multi.shape == (80, 64, 3)
    np.testing.assert_array_equal(single, multi)
