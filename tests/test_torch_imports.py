"""The port stands alone: no module of moephoto_tpu_torch, and neither
chip_smoke.py nor app_torch.py, imports JAX or the JAX package.  And every
port test module runs torch on one thread (``tests/torch_one_thread.py``)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "moephoto_tpu")


def _portFiles():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "app_torch.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "moephoto_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)  # one order in every test worker


def _forbidden(name: str) -> bool:
    # exact names or their submodules: "moephoto_tpu_torch" is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _portFiles(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    with open(path, encoding="utf-8") as fp:
        tree = ast.parse(fp.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, bad


def test_port_entry_modules_load_without_jax():
    code = ("import sys, moephoto_tpu_torch.cli, moephoto_tpu_torch.pipeline.steps, "
            "moephoto_tpu_torch.video.engine, moephoto_tpu_torch.models.ifrnet, moephoto_tpu_torch.models.iconvsr, "
            "moephoto_tpu_torch.models.estrnn, moephoto_tpu_torch.runtime.server, moephoto_tpu_torch.runtime.worker, "
            "moephoto_tpu_torch.tools.train, moephoto_tpu_torch.tools.dryrun, moephoto_tpu_torch.parallel.sharded, "
            "app_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'moephoto_tpu' or m.startswith('moephoto_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_every_port_test_module_takes_one_torch_thread():
    """Each ``tests/test_torch_*.py`` imports the autouse ``oneTorchThread``,
    so that no port test runs torch's default pool under the suite's workers."""
    missing = []
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py"))):
        with open(path, encoding="utf-8") as fp:
            tree = ast.parse(fp.read(), path)
        if not any(isinstance(node, ast.ImportFrom) and node.module == "tests.torch_one_thread"
                   and any(a.name == "oneTorchThread" for a in node.names) for node in tree.body):
            missing.append(os.path.basename(path))
    assert not missing, f"these modules do not import oneTorchThread from tests.torch_one_thread: {missing}"
