"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the plain references load nothing of the
program."""

import os
import subprocess
import sys

from benchmark.harness import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "moephoto_tpu", "moephoto_tpu.ops.warp",
             "moephoto_tpu_torch", "moephoto_tpu_torch.ops", "jaxtyping", "flaxen", "moephoto_tpu2"]
    assert guard.loaded(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "moephoto_tpu",
                                   "moephoto_tpu.ops.warp"]


def test_the_benchmark_sources_import_nothing_forbidden():
    assert guard.sourceFaults() == []


def test_faults_are_found(tmp_path, monkeypatch):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "plain.py").write_text("import torch\nfrom moephoto_tpu_torch.models import sr\n")
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "d.py").write_text("import moephoto_tpu_torch\nimport jax.numpy as jnp\n")
    (tmp_path / "drivers" / "e.py").write_text("from moephoto_tpu.ops import warp\n")
    monkeypatch.setattr(guard, "BENCH", str(tmp_path))
    assert sorted(guard.sourceFaults()) == sorted([
        os.path.join("drivers", "d.py") + " imports jax.numpy",
        os.path.join("drivers", "e.py") + " imports moephoto_tpu.ops",
        os.path.join("reference", "plain.py") + " imports moephoto_tpu_torch.models"])


def _fresh(code: str) -> str:
    env = dict(os.environ, USE_FLAX="0")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          check=True, timeout=600).stdout.strip().splitlines()[-1]


def test_references_load_nothing_of_the_program():
    out = _fresh("import sys; sys.path.insert(0, '.')\n"
                 "from benchmark.reference import bounds, flops, ifrnet, layers, lite\n"
                 "print(sorted(n for n in sys.modules if n.split('.')[0] in "
                 "('moephoto_tpu_torch', 'moephoto_tpu', 'jax', 'jaxlib', 'flax')))")
    assert out == "[]"


def test_a_run_loads_nothing_forbidden():
    """A short run of each kind of cell on the CPU, in a fresh process."""
    out = _fresh("import sys, tempfile; sys.path.insert(0, '.')\n"
                 "from benchmark.tests.helpers import runTiny\n"
                 "import pathlib\n"
                 "for name in ('sr_lite4_1080p', 'slomo_ifrnet_m_1080p'):\n"
                 "    runTiny(name, pathlib.Path(tempfile.mkdtemp()), seconds=0.2)\n"
                 "from benchmark.harness import guard\n"
                 "print(guard.loaded())")
    assert out == "[]"
