"""The port's deployment packager (moephoto_tpu_torch/tools/package.py) on
the CPU: a tree made with --skip-kernels holds the package with its CUDA
sources and without built libraries or caches, the frontend, the app, the
manifest with the JAX packager's keys, and imports with no ``jax``; with
--models lite2 it holds a .pt2 program that loads and runs on the CPU."""

import json
import os
import subprocess
import sys

import torch

from moephoto_tpu_torch.config import VERSION, config
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.synth import synthLite2Params
from moephoto_tpu_torch.tools import package
from moephoto_tpu_torch.tools.export import loadExported
from tests.torch_one_thread import oneTorchThread  # noqa: F401

JAX_KEYS = {"name", "version", "buildTime", "python", "entry", "ufile"}


def _pack(tmp_path, *extra):
    out = tmp_path / "tree"
    result = package.main(["--out", str(out), "--skip-kernels", *extra])
    assert result["out"] == str(out) and result["kernels"] == []
    return out, result


def test_tree_holds_the_package_frontend_and_manifest(tmp_path, capsys):
    out, result = _pack(tmp_path)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert result["exports"] == []
    for rel in ("app_torch.py", "README.md", "pyproject.toml", "templates", "static", "model/README.md",
                "moephoto_tpu_torch/cli.py", "moephoto_tpu_torch/ops/_build.py"):
        assert (out / rel).exists(), rel
    sources = sorted(os.listdir(package._build.CSRC))
    assert sorted(os.listdir(out / "moephoto_tpu_torch" / "csrc")) == sources
    assert not (out / "moephoto_tpu").exists() and not (out / "build").exists()
    shipped = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs]
    assert not any(f.endswith((".so", ".pyc")) or "__pycache__" in f for f in shipped)
    man = json.loads((out / "manifest.json").read_text())
    assert JAX_KEYS <= set(man) and man["entry"] == "app_torch.py" and man["version"] == VERSION
    assert man["kernels"] == []


def test_tree_package_imports_without_jax(tmp_path):
    """From the tree's root, in a fresh process: the package, its CLI, app
    and kernel loader import, from the tree, with no jax module loaded;
    the loader looks for libraries under the tree's build/."""
    out, _ = _pack(tmp_path)
    code = ("import sys, moephoto_tpu_torch, moephoto_tpu_torch.cli, moephoto_tpu_torch.runtime.server, "
            "moephoto_tpu_torch.tools.export\n"
            "from moephoto_tpu_torch.ops import _build\n"
            "print(moephoto_tpu_torch.__file__); print(_build.BUILD)\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'moephoto_tpu.'))]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(out), env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    pkgFile, build = proc.stdout.strip().splitlines()
    assert pkgFile.startswith(str(out)) and build == str(out / "build")


def test_models_export_a_loadable_program(tmp_path):
    (tmp_path / "models" / "lite").mkdir(parents=True)
    torch.save(synthLite2Params(2, 0), str(tmp_path / "models" / "lite" / "model.pth"))
    saved = (config.device, config.modelDir)
    caches = (registry._modelCache, registry._paramsCache)
    for c in caches:
        c.clear()
    config.device, config.modelDir = "cpu", str(tmp_path / "models")
    try:
        out, result = _pack(tmp_path, "--models", "lite2")
        assert result["exports"] == ["lite2"]
        program = loadExported(str(out / "exports" / "lite2.pt2"))
        y = program(torch.rand((1, 256, 256, 1)))
    finally:
        config.device, config.modelDir = saved
        for c in caches:
            c.clear()
    assert y.shape == (1, 512, 512, 1) and bool(torch.isfinite(y).all())
