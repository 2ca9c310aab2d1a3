"""The port's TileSpec calibration (moephoto_tpu_torch/tools/calibrate.py)
on the CPU at a tiny size: one line a point and a ``best:`` line naming
the fastest; an out-of-memory point prints FAILED and the sweep goes on,
any other error stops it; no registry spec changes."""

import re

import pytest
import torch

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.synth import synthLite2Params
from moephoto_tpu_torch.tools import calibrate
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ARGS = ["lite2", "--tiles", "32,48", "--batches", "1,2", "--size", "64x96"]
POINT = re.compile(r"^tile=(\d+) batch=(\d+): ([0-9.]+) Mpx/s$")


@pytest.fixture
def lite(tmp_path):
    (tmp_path / "lite").mkdir()
    torch.save(synthLite2Params(2, 0), str(tmp_path / "lite" / "model.pth"))
    saved = (config.device, config.modelDir)
    caches = (registry._modelCache, registry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir = "cpu", str(tmp_path)
    yield
    config.device, config.modelDir = saved
    for c in caches:
        c.clear()


def test_sweep_prints_every_point_and_the_best(lite, capsys):
    spec = registry.SR_REGISTRY["lite2"]["spec"]
    results = calibrate.main(ARGS)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    points = [POINT.match(ln) for ln in lines[1:-1]]
    assert all(points) and [(int(m[1]), int(m[2])) for m in points] == [(32, 1), (32, 2), (48, 1), (48, 2)]
    assert [(r["tile"], r["batch"]) for r in results] == [(32, 1), (32, 2), (48, 1), (48, 2)]
    assert all(r["peak_mib"] is None for r in results)  # no device memory on the CPU
    best = max(results, key=lambda r: r["mpx_per_s"])
    assert lines[-1] == f"best: tile={best['tile']} batch={best['batch']} -> {best['mpx_per_s']:.2f} Mpx/s"
    assert registry.SR_REGISTRY["lite2"]["spec"] == spec


def _failingAt(monkeypatch, tile, error):
    call = ModelExec.__call__

    def patched(self, x):
        if self.spec.tile == tile:
            raise error
        return call(self, x)

    monkeypatch.setattr(ModelExec, "__call__", patched)


def test_out_of_memory_prints_failed(lite, monkeypatch, capsys):
    _failingAt(monkeypatch, 48, torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    results = calibrate.main(ARGS)
    out = capsys.readouterr().out
    assert [(r["tile"], r["batch"]) for r in results] == [(32, 1), (32, 2)]
    assert "tile=48 batch=1: FAILED (CUDA out of memory. Tried to allocate 2.00 GiB)" in out
    assert "tile=48 batch=2: FAILED" in out and "\nbest: tile=32" in out


def test_other_errors_propagate(lite, monkeypatch):
    _failingAt(monkeypatch, 32, RuntimeError("cuDNN error"))
    with pytest.raises(RuntimeError, match="cuDNN error"):
        calibrate.main(ARGS)
