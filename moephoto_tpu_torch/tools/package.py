"""Deployment packager: the counterpart of the JAX package's
``tools/package.py`` (role of the reference's ``setup_run.py:34-58``:
manifest generation, native build, deploy-tree assembly).  Where the JAX
tree ships its frame codec built, this one ships the port's four CUDA
kernel libraries built for ``sm_90a``, so the tree runs with no ``nvcc``
on the target; model exports are ``torch.export`` programs.

Usage:
  python -m moephoto_tpu_torch.tools.package [--out dist/moephoto-torch]
                                            [--models lite2 ...] [--skip-kernels]

Produces a self-contained tree:
  app_torch.py  moephoto_tpu_torch/ (with csrc/)  templates/  static/
  README.md  pyproject.toml  manifest.json
  build/lib<kernel>_<hash>.so      (nvcc, unless --skip-kernels)
  model/                           (placeholder + README)
  exports/<name>.pt2               (for each --models entry)

The tree runs with ``python app_torch.py`` (or ``python -m
moephoto_tpu_torch.cli``) from its root: its ``ops/_build.py`` looks for
the libraries under the tree's ``build/``, by the same content-keyed
names, and finds them built.  A kernel build that fails, or an export
that fails, stops the packager with an error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

from moephoto_tpu_torch.ops import _build

ROOT = os.path.dirname(_build.PKG)
ARCH = "sm_90a"
SHIPPED = ("app_torch.py", "README.md", "pyproject.toml")


def buildKernels(out: str) -> list:
    """Build every ``csrc/*.cu`` (:func:`_build.loadAll`, one ``nvcc``
    each, all at once) and copy the libraries into ``<out>/build`` under
    the names :func:`_build.libraryPath` gives; returns what it shipped."""
    sources = sorted(os.path.basename(p) for p in glob.glob(os.path.join(_build.CSRC, "*.cu")))
    _build.loadAll(sources)
    os.makedirs(os.path.join(out, "build"))
    shipped = []
    for source in sources:
        lib = _build.libraryPath(source)
        shutil.copy2(lib, os.path.join(out, "build", os.path.basename(lib)))
        shipped.append({"source": f"moephoto_tpu_torch/csrc/{source}", "library": f"build/{os.path.basename(lib)}",
                        "arch": ARCH})
    return shipped


def manifest() -> dict:
    from moephoto_tpu_torch.config import VERSION

    return {
        "name": "MoePhoto-Torch",
        "version": VERSION,
        "buildTime": int(time.time()),
        "python": ">=3.10",
        "entry": "app_torch.py",
        "ufile": ".user/",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dist/moephoto-torch")
    ap.add_argument("--models", nargs="*", default=[], help="registry model names to export as .pt2 programs")
    ap.add_argument("--skip-kernels", action="store_true")
    args = ap.parse_args(argv)

    out = os.path.abspath(args.out)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)

    # package source with its kernel sources (no caches, no built libraries)
    shutil.copytree(os.path.join(ROOT, "moephoto_tpu_torch"), os.path.join(out, "moephoto_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"))
    for d in ("templates", "static"):
        shutil.copytree(os.path.join(ROOT, d), os.path.join(out, d))
    for f in SHIPPED:
        shutil.copy2(os.path.join(ROOT, f), out)

    kernels = [] if args.skip_kernels else buildKernels(out)

    os.makedirs(os.path.join(out, "model"))
    with open(os.path.join(out, "model", "README.md"), "w") as fp:
        fp.write("Place checkpoints here using the reference's model/ layout (see "
                 "moephoto_tpu_torch/pipeline/registry.py), or point the modelDir config key elsewhere.\n")

    man = manifest()
    man["kernels"] = kernels
    with open(os.path.join(out, "manifest.json"), "w") as fp:
        json.dump(man, fp, indent=2)

    exported = []
    if args.models:
        from moephoto_tpu_torch.tools.export import exportModel

        os.makedirs(os.path.join(out, "exports"))
        for name in args.models:
            exportModel(name, os.path.join(out, "exports", f"{name}.pt2"))
            exported.append(name)

    result = {"out": out, "kernels": [k["library"] for k in kernels], "exports": exported}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
