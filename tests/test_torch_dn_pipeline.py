"""The port's ``DN`` and ``resize`` steps and its MyNet SR entries
(moephoto_tpu_torch/pipeline/registry.py ``getDN``, ``getSR``; steps.py
``procDN``, ``resizeStep``) against the JAX package's, on the denoise ->
SR chain (DN lite5 -> SR lite x4) and on the image steps of the reference's
benchmark preset (SR lite x2 -> resize -> DN lite5 -> SR a x2 -> dehaze),
with one synthetic checkpoint per model in a temporary modelDir that both
packages read (NetDN's as the ``.npz`` a JAX converter writes, the others
as ``.pth``).

Tolerances: tiled outputs 5e-5 absolute in fp32 (up to 35 conv layers,
then the overlap-add blend; order-1 values), against a JAX ``ModelExec``
run unpacked with ``channelSplit``, as the port runs; CLI pixels within
1 LSB of the JAX pipeline, which runs these models plane-packed (the fp32
results differ by ~1e-5 and may round apart)."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from moephoto_tpu import cli as jaxCli
from moephoto_tpu import progress as jaxProgress
from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.engine.executor import ModelExec as JaxModelExec
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import sr as jaxSr
from moephoto_tpu.pipeline import registry as jaxRegistry
from moephoto_tpu.pipeline import steps as jaxSteps
from moephoto_tpu_torch import cli, progress
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline import registry, steps
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.synth import (synthAODParams, synthIFRNetParams, synthLite2Params, synthMyNetParams,
                                      synthNetDNParams, synthSEDNParams)
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

CHAIN = [{"op": "DN", "model": "lite5"}, {"op": "SR", "model": "lite", "scale": 4}]
PRESET = [{"scale": 2, "model": "lite", "ensemble": 0, "op": "SR"},
          {"method": "bilinear", "width": 40, "height": 24, "op": "resize"},
          {"model": "lite5", "op": "DN"},
          {"scale": 2, "model": "a", "ensemble": 0, "op": "SR"},
          {"op": "dehaze"}]
TILED_TOL = 5e-5
CONFIG_KEYS = ("device", "modelDir", "tileSize", "crop_sr", "crop_dn", "crop_dns")


@pytest.fixture
def models(tmp_path):
    """Synthetic checkpoints in a temporary modelDir seen by both
    packages; caches cleared and configs restored after."""
    sds = {"dn_lite5/model_new": synthNetDNParams(31), "l15/model_new": synthSEDNParams(32),
           "a2/model_new": synthMyNetParams(2, 33), "a3/model_new": synthMyNetParams(3, 34),
           "lite/model_4": synthLite2Params(4, 35), "lite/model": synthLite2Params(2, 36),
           "dehaze/AOD_net_epoch_relu_10": synthAODParams(37)}
    for rel, sd in sds.items():
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        if rel.startswith("dn_lite5"):
            np.savez(str(tmp_path / (rel + ".npz")), **JA.convertStateDict({k: v.numpy() for k, v in sd.items()}))
        else:
            torch.save(sd, str(tmp_path / (rel + ".pth")))
    saved = [(cfg, k, getattr(cfg, k)) for cfg in (config, jaxConfig) for k in CONFIG_KEYS if hasattr(cfg, k)]
    caches = (registry._modelCache, registry._paramsCache, jaxRegistry._modelCache, jaxRegistry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir, jaxConfig.modelDir = "cpu", str(tmp_path), str(tmp_path)
    yield {"dir": tmp_path, "sds": sds}
    for cfg, k, v in saved:
        setattr(cfg, k, v)
    for c in caches:
        c.clear()


def _image(seed, h, w, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


def _jaxExec(fn, sd, spec, **kw):
    """The JAX ModelExec as the port runs the model: unpacked, channels
    folded into the batch, on the JAX entry's tile spec."""
    import jax.numpy as jnp

    params = {k: jnp.asarray(v) for k, v in JA.convertStateDict({k: v.numpy() for k, v in sd.items()}).items()}
    return JaxModelExec(fn, params, spec, channelSplit=True, dtype=jnp.float32, **kw)


def test_getdn_strength_keys_the_cache_and_blends(models):
    x = _image(1, 30, 36)
    half = registry.getDN({"model": "lite5", "strength": 0.6})
    full = registry.getDN({"model": "lite5"})
    assert half is not full and half.strength == 0.6 and full.strength == 1.0
    assert registry.getDN({"model": "lite5", "strength": 0.6}) is half
    assert half.model is full.model  # one set of weights
    got = half(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, 0.6 * full(torch.from_numpy(x)).numpy() + 0.4 * x, atol=1e-6, rtol=0)
    ref = np.asarray(jaxRegistry.getDN({"model": "lite5", "strength": 0.6})(x))
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


def test_getdn_takes_the_dn_or_dns_crop_cap(models):
    """``lite*`` models follow ``crop_dn``, SEDN ``crop_dns``, SR ``crop_sr``,
    as the JAX registry."""
    for cfg in (config, jaxConfig):
        cfg.crop_sr, cfg.crop_dn, cfg.crop_dns = 96, 64, 128
    for reg in (registry, jaxRegistry):
        assert reg.getDN({"model": "lite5"}).spec.tile == 64
        assert reg.getDN({"model": "15"}).spec.tile == 128
        assert reg.getSR({"model": "a", "scale": 2}).spec.tile == 96
    spec = lambda entry: dataclasses.astuple(entry["spec"])
    for key in ("15", "25", "50", "lite5", "lite10", "lite15"):
        assert spec(registry.DN_REGISTRY[key]) == spec(jaxRegistry.DN_REGISTRY[key])
        assert registry.DN_REGISTRY[key]["path"] == jaxRegistry.DN_REGISTRY[key]["path"]
    for key in ("a2", "a3", "a4", "p2", "p3", "p4"):
        assert spec(registry.SR_REGISTRY[key]) == spec(jaxRegistry.SR_REGISTRY[key])
        assert registry.SR_REGISTRY[key]["path"] == jaxRegistry.SR_REGISTRY[key]["path"]
    assert not registry.getDN({"model": "lite5"}).pack and registry.getDN({"model": "lite5"}).channelSplit


@pytest.mark.parametrize("model,fn,rel", [("lite5", jaxSr.netDN, "dn_lite5/model_new"),
                                          ("15", jaxSr.sedn, "l15/model_new")])
def test_tiled_dn_matches_jax(models, model, fn, rel):
    """64 px tiles on a 70x96 image: several tiles and blended seams."""
    config.tileSize = 64
    x = _image(2, 70, 96)
    ex = registry.getDN({"model": model})
    got = ex(torch.from_numpy(x)).numpy()
    ref = np.asarray(_jaxExec(fn, models["sds"][rel], ex.spec)(x))
    assert got.shape == ref.shape == (70, 96, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


@pytest.mark.parametrize("scale,fn", [(2, jaxSr.net2x), (3, jaxSr.net3x)])
def test_tiled_mynet_sr_matches_jax(models, scale, fn):
    config.tileSize = 48
    x = _image(3, 50, 66)
    ex = registry.getSR({"model": "a", "scale": scale})
    got = ex(torch.from_numpy(x)).numpy()
    ref = np.asarray(_jaxExec(fn, models["sds"][f"a{scale}/model_new"], ex.spec)(x))
    assert got.shape == ref.shape == (50 * scale, 66 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL, rtol=0)


def test_registries_hold_every_jax_key_and_entry(models):
    """The port's SR, DN and dehaze registries have exactly the JAX
    package's keys, each entry the JAX entry's tile spec, family,
    constructor name and checkpoint path; every step op is ported."""
    for port, jax_ in ((registry.SR_REGISTRY, jaxRegistry.SR_REGISTRY), (registry.DN_REGISTRY, jaxRegistry.DN_REGISTRY),
                       (registry.DEHAZE_REGISTRY, jaxRegistry.DEHAZE_REGISTRY)):
        assert set(port) == set(jax_)
        for key, entry in port.items():
            want = jax_[key]
            assert dataclasses.astuple(entry["spec"]) == dataclasses.astuple(want["spec"]), key
            assert (entry["family"], entry["fn"], entry["path"]) == (want["family"], want["fn"], want["path"]), key
            assert callable(getattr(registry._lazyImport(entry["family"]), entry["fn"])), key
    assert not any(hasattr(registry, f"{k}_NOT_PORTED") for k in ("SR", "DN", "DEHAZE"))
    assert set(steps.procs) == set(jaxSteps.procs) and not hasattr(steps, "NOT_PORTED")  # every step op is ported


RESIZES = {
    "scale_bilinear": dict(scaleH=1.5, scaleW=0.5),
    "size_nearest": dict(width=37, height=19, method="nearest"),
    "size_bicubic_down": dict(width=20, height=14, method="bicubic"),
    "scale_bicubic_up": dict(scaleH=2.5, scaleW=1.3, method="bicubic"),
    "bankers_rounding": dict(scaleH=0.5, scaleW=0.5),  # 25 x 0.5 = 12.5 -> 12, 33 x 0.5 = 16.5 -> 16
}


@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_step_matches_jax(name):
    """Output, this node's load and the later nodes' loads, as JAX's."""
    from moephoto_tpu.progress import Node as JaxNode

    x = _image(4, 25, 33)
    out = {"source": 0}
    nodes = [progress.Node({"op": "a"}, 3), progress.Node({"op": "resize"}, 3), progress.Node({"op": "b"}, 5)]
    jaxNodes = [JaxNode({"op": "a"}, 3), JaxNode({"op": "resize"}, 3), JaxNode({"op": "b"}, 5)]
    got = steps.resizeStep(dict(RESIZES[name], op="resize"), out, 1, nodes)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jaxSteps.resizeStep(dict(RESIZES[name], op="resize"), out, 1, jaxNodes)(x))
    assert got.shape == ref.shape
    if name == "bankers_rounding":
        assert got.shape == (12, 16, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert [n.load for n in nodes] == [n.load for n in jaxNodes]
    assert nodes[0].load == 3 and nodes[1].load == x.size and nodes[2].load != 5


def test_resize_step_updates_loads_once_for_a_video_source():
    nodes = [progress.Node({"op": "resize"}, 1), progress.Node({"op": "b"}, 8)]
    f = steps.resizeStep(dict(op="resize", width=10, height=6), {"source": 1}, 0, nodes)
    a = f(torch.zeros(12, 20, 3))
    load = nodes[1].load
    b = f(torch.zeros(12, 20, 3))
    assert a.shape == b.shape == (6, 10, 3) and nodes[1].load == load == 8 * 60 / 240
    stills = steps.resizeStep(dict(op="resize", width=10, height=6), {"source": 0}, 0, nodes)
    stills(torch.zeros(12, 20, 3)), stills(torch.zeros(12, 20, 3))
    assert nodes[1].load == load / 16  # an image source rescales on every image


def _runBoth(models, chain, shape, seed):
    src = str(models["dir"] / "in.png")
    rgb = np.random.RandomState(seed).randint(0, 256, shape, np.uint8)
    Image.fromarray(rgb).save(src)
    cli.runImage(src, str(models["dir"] / "port.png"), chain)
    jaxCli.runImage(src, str(models["dir"] / "jax.png"), chain)
    got = np.asarray(Image.open(models["dir"] / "port.png")).astype(np.int32)
    ref = np.asarray(Image.open(models["dir"] / "jax.png")).astype(np.int32)
    return got, ref


def test_cli_dn_sr_chain_matches_jax(models):
    got, ref = _runBoth(models, CHAIN, (30, 41, 3), 5)
    assert got.shape == ref.shape == (120, 164, 3)
    assert np.abs(got - ref).max() <= 1 and got.std() > 1


def test_cli_preset_image_steps_match_jax(models):
    """SR lite x2 -> resize to 40x24 -> DN lite5 -> SR a x2 -> dehaze."""
    got, ref = _runBoth(models, PRESET, (26, 44, 3), 6)
    assert got.shape == ref.shape == (48, 80, 3)
    assert np.abs(got - ref).max() <= 1 and got.std() > 1


def _opOf(mod, node) -> dict:
    return mod._registry[node.op].op


def test_gen_process_nodes_match_jax(models):
    """The preset's progress nodes (ops, loads) as JAX builds them, and
    after one image the loads the resize step rescaled."""
    chain = lambda: [{"op": "file"}] + [dict(s) for s in PRESET] + [{"op": "output"}]
    _, nodes = steps.genProcess(chain())
    _, jaxNodes = jaxSteps.genProcess(chain())
    flat = lambda mod, ns: [(_opOf(mod, n), n.load, n.total) for n in ns]
    assert flat(progress, nodes) == flat(jaxProgress, jaxNodes)
    ops = [_opOf(progress, n).get("op") for n in nodes]
    assert ops.count("resize") == 1 and ops.count("DN") == 1 and ops.count("SR") == 2


def test_resize_after_slomo_runs_per_frame_inside_it(models, monkeypatch):
    """``resize`` and ``DN`` after a temporal step compile with
    ``root=False`` and run on every output frame."""
    (models["dir"] / "IFRNet").mkdir()
    torch.save(synthIFRNetParams("S", 3), str(models["dir"] / "IFRNet" / "IFRNet_S_GoPro.pth"))
    monkeypatch.setattr(config, "opsPath", str(models["dir"] / "ops.json"))
    monkeypatch.setattr(context, "root", progress.Node({"op": "video"}, 1, 5))  # the video engine's root node
    chain = [{"op": "buffer", "bitDepth": 16}, {"op": "slomo", "model": "IFRNet S", "sf": 2},
             {"op": "resize", "width": 20, "height": 12, "method": "nearest"}, {"op": "DN", "model": "lite5"},
             {"op": "output"}]
    process, nodes = steps.genProcess(chain)
    after = nodes[-1].nodes
    assert [_opOf(progress, n).get("op") for n in after][:2] == ["resize", "DN"]
    rng = np.random.RandomState(7)
    outs = []
    for _ in range(3):
        raw = rng.randint(0, 65536, (24, 40, 3)).astype(np.uint16)
        outs += process((raw.tobytes(), 24, 40)) or []
    outs += process((None, 24, 40)) or []  # end of stream, as the video engine flushes
    frames = [o for o in outs if o is not None]
    assert len(frames) == 5 and all(len(f) == 12 * 20 * 6 for f in frames)  # bgr48le at 20x12
