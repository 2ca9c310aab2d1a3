"""The port's runtime helpers against the JAX package's on the same
inputs: the FIFO note cache, the progress tree's editing methods, the
preset store, the updater's offline parts, the config keys and memory
helpers; and the shared frontend's step builder (static/js/moe.js)
against the port's step tables and video engine."""

import inspect
import io
import json
import os
import zipfile

import pytest
import torch

import moephoto_tpu.progress as jaxProgress
import moephoto_tpu.runtime.preset as jaxPreset
import moephoto_tpu.runtime.updater as jaxUpdater
import moephoto_tpu.utils.fifocache as jaxFifo
import moephoto_tpu_torch.progress as progress
import moephoto_tpu_torch.runtime.preset as preset
import moephoto_tpu_torch.runtime.updater as updater
import moephoto_tpu_torch.utils.fifocache as fifo
from moephoto_tpu.config import VERSION as JAX_VERSION, defaultConfig as jaxDefaults
from moephoto_tpu_torch.config import Config, VERSION, defaultConfig
from test_frontend import _parseMoeOps
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

# --- fifocache ----------------------------------------------------------------

def cacheRun(Cache):
    evicted = []
    c = Cache(3, ("", 200), lambda k, v: evicted.append((k, v)))
    out = []
    c.put("a", {"eta": 1})
    c.put("b", 2)
    c.update("a", {"gone": 3})
    out.append(c.peek("a"))
    c.put("c", 3)
    c.put("a", {"eta": 5})  # a refresh moves it to the end
    c.put("d", 4)  # evicts b, the oldest
    c.update("e", {"x": 1})  # evicts c
    out += [c.pop("a"), c.pop("b"), c.pop("zz"), c.peek("d"), c.peek("c"), c.pop("e")]
    for i in range(5):
        c.put(i, i)
    return out, evicted


def test_fifo_cache_matches_jax():
    got, want = cacheRun(fifo.Cache), cacheRun(jaxFifo.Cache)
    assert got == want
    assert got[0][1:4] == [{"eta": 5}, ("", 200), ("", 200)] and got[1][0] == ("b", 2)


# --- progress -----------------------------------------------------------------

def treeRun(P):
    """One sequence of tree edits; a snapshot (name, eta, ett, gone, total,
    parent) of every node in walk order after each."""
    notes = []
    mk = lambda name, load, total: P.Node({"op": f"parity_{name}"}, load, total, learn=0, name=name)
    root, a, b, a1, a2, c = (mk("root", 1, 2), mk("a", 2, 3), mk("b", 1, 4), mk("a1", 3, 1),
                             mk("a2", 1, 2), mk("c", 5, 1))
    root.append(a).append(b)
    a.append(a1).append(a2)
    b.append(c)
    P.initialETA(root)
    for n in (root, a, b, a1, a2, c):
        n.setCallback(lambda node, info: notes.append((node.name, dict(info))))
    snaps = []

    def snap():
        rows = []
        P.recurse(lambda n: rows.append((n.name, n.eta, n.ett, n.gone, n.total,
                                         n.parent.name if n.parent else None)))(root)
        snaps.append(rows)

    snap()
    a2.trace()
    snap()
    c.moveTo(a, 0)
    snap()
    b.moveTo(a)
    snap()
    a1.remove(True)
    snap()
    c.moveTo(root, 1)
    snap()
    a2.update({"total": 5, "load": 3})
    snap()
    a2.update({"op": {"op": "parity_a1"}})
    snap()
    a2.trace()
    b.toStop()
    snap()
    return snaps, notes


def test_progress_tree_edits_match_jax():
    """recurse, remove, moveTo, update and toStop on the same trees: the
    same estimates, counts, totals, node order and callbacks."""
    got, want = treeRun(progress), treeRun(jaxProgress)
    assert got == want
    assert [r[0] for r in got[0][-1]] == ["root", "a", "a2", "b", "c"]
    assert got[0][-1][-1][4] == 1  # toStop: total = gone + 1


# --- preset -------------------------------------------------------------------

def presetRun(module, directory, monkeypatch):
    """list, save, list, fetch, missing, incompatible version, a broken file,
    a path outside the types and bad data, in a store under ``directory``."""
    monkeypatch.chdir(directory)
    monkeypatch.setattr(module, "_stores", {})
    monkeypatch.setattr(module, "version", module.version)
    module.initPreset({"version": "5.15"})
    h = module.handlePreset
    item = {"name": "p1", "version": "5.15", "notes": ["n"], "steps": [{"op": "SR", "model": "lite", "scale": 2}]}
    out = [h({"path": "image"}), h({"path": "image", "data": json.dumps(item)}), h({"path": "image"}),
           h({"path": "image", "name": "p1"}), h({"path": "image", "name": "nope"})]
    store = directory / ".user" / "preset_video"
    store.mkdir(parents=True)
    (store / "new.json").write_text(json.dumps(dict(item, name="new", version="9.1")))
    (store / "broken.json").write_text("{")
    (store / "old.json").write_text(json.dumps(dict(item, name="old", version="5.0")))
    out += [h({"path": "video", "name": "new"}), h({"path": "video", "name": "broken"}), h({"path": "video"}),
            h({"path": "../etc"}), h({"path": "../etc", "name": "passwd"}), h({"path": "image", "data": "not json"})]
    return out


def test_preset_store_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = presetRun(jaxPreset, tmp_path / "jax", monkeypatch)
    got = presetRun(preset, tmp_path / "port", monkeypatch)
    assert got == want
    assert got[0] == ("[]", 200) and got[1] == ("p1", 200) and got[4] == ("", 404)
    assert got[5] == ("Incompatible version", 200) and got[8:10] == [("", 403), ("", 403)]
    assert json.loads(got[7][0]) == [{"name": "old", "notes": ["n"]}]


# --- updater (offline parts, the network stubbed) ------------------------------

def zipBytes(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return buf.getvalue()


def updaterRun(module, directory, monkeypatch):
    served = {"http://m/ok": b'{"version": "9.0", "files": [{"path": "a/b.txt", "url": "http://f/b"}]}',
              "http://m/old": b'{"version": "5.0"}', "http://m/bad": b"not json",
              "http://f/b": b"payload", "http://f/ff.zip": zipBytes({"bin/ffmpeg": b"elf", "LICENSE": b"gpl"}),
              "http://f/broken.zip": b"PK not a zip"}
    monkeypatch.setattr(module, "fetch", lambda url, timeout=10: served.get(url))

    def download(url, dest, threads=4):
        if url not in served:
            return False
        with open(dest, "wb") as fp:
            fp.write(served[url])
        return True

    monkeypatch.setattr(module, "downloadRanged", download)
    out = [module.checkUpdate(u) for u in ("http://m/ok", "http://m/old", "http://m/bad", "http://m/none")]
    out.append(module.update("http://m/ok", str(directory / "app")))
    out.append(module.update("http://m/old", str(directory / "app2")))
    out.append(module.updateFfmpeg("http://f/ff.zip", str(directory / "ff")))
    out.append(module.updateFfmpeg("http://f/none.zip", str(directory / "ff2")))
    tree = sorted((os.path.relpath(os.path.join(d, n), directory), open(os.path.join(d, n), "rb").read())
                  for d, _, names in os.walk(directory) for n in names)
    return out, tree


def test_updater_offline_parts_match_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = updaterRun(jaxUpdater, tmp_path / "jax", monkeypatch)
    got = updaterRun(updater, tmp_path / "port", monkeypatch)
    assert got == want
    assert got[0][1:] == [None, None, None, True, False, True, False]
    assert ("ff/bin/ffmpeg", b"elf") in got[1] and ("app/a/b.txt", b"payload") in got[1]
    assert not any(p.endswith("_ffmpeg.zip") for p, _ in got[1] if p.startswith("ff/"))


# --- config -------------------------------------------------------------------

NEW_KEYS = ("port", "sharedMemSize", "maxResultsKept")
# JAX keys that nothing reads there either; the port does not carry them
INERT_JAX_KEYS = ("maxMemoryUsage", "maxGraphicMemoryUsage", "deviceId")


def test_config_defaults_match_jax_for_shared_keys():
    port, jax = defaultConfig, jaxDefaults
    shared = set(port) & set(jax)
    assert set(NEW_KEYS) <= shared and "meshBackend" not in port
    assert not set(INERT_JAX_KEYS) & set(port) and set(INERT_JAX_KEYS) <= set(jax)
    assert {k: port[k][0] for k in shared} == {k: jax[k][0] for k in shared}


def test_jax_user_config_loads(tmp_path):
    """A .user/config.json written for the JAX app, every key of its
    defaults as ``[value]`` (meshBackend and the keys the port does not
    carry too), loads into the port's config, its values over the
    defaults."""
    user = {k: [v[0]] for k, v in jaxDefaults.items()}
    user.update(version=JAX_VERSION, port=2400, sharedMemSize=[2**20], maxResultsKept=8, deviceId=1)
    (tmp_path / ".user").mkdir()
    (tmp_path / ".user" / "config.json").write_text(json.dumps(user))
    cfg = Config(str(tmp_path))
    assert (cfg.port, cfg.sharedMemSize, cfg.maxResultsKept) == (2400, 2**20, 8)
    assert cfg.device == "cuda" and cfg.version == VERSION


def test_system_memory_per_device(monkeypatch):
    """One entry a device: on the CPU, 0 (no memory stats); with CUDA
    asked for and absent, it raises."""
    cfg = Config()
    cfg.device = "cpu"
    assert cfg.system() == [0]
    cfg.device = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cfg.system()


# --- the frontend against the port ---------------------------------------------

def test_moe_panel_schema_matches_port_pipeline():
    """Every op the shared step builder can emit is accepted by the port's
    pipeline/steps.py, and every numeric field it serializes is in that
    op's coercion table."""
    from moephoto_tpu_torch.pipeline.steps import procs, stepOpts

    ops = _parseMoeOps()
    assert ops, "no ops parsed"
    extra = {
        "SR": {"model"},
        "DN": {"model"},
        "dehaze": {"model"},
        "resize": set(),
        "slomo": {"sf", "dedupe"},
        "VSR": set(),
        "demob": set(),
    }
    for op, fields in ops.items():
        assert op in procs, f"frontend emits op {op!r} the port's pipeline lacks"
        so = stepOpts.get(op, {})
        coerced = set(so.get("toInt", [])) | set(so.get("toFloat", [])) | set(so.get("isEnabled", []))
        for f in fields:
            assert f in coerced or f in extra.get(op, set()), f"{op}.{f} not in the port's coercion tables"


def test_video_chain_frame_ops_exist_in_port():
    """The video payload frame maps to the port's engine: output/file are
    pipeline ops; decode/range are read positionally by
    video/engine.prepare (steps[0]/steps[1])."""
    from moephoto_tpu_torch.pipeline.steps import procs
    from moephoto_tpu_torch.video import engine

    for op in ("output", "file"):
        assert op in procs
    src = inspect.getsource(engine.prepare)
    assert "steps[0]" in src and "steps[1]" in src
