"""What the benchmark may not load: JAX (``jax``, ``jaxlib``, ``flax``) or
the JAX package (``moephoto_tpu``) anywhere, and the program under test
(``moephoto_tpu_torch``) in the plain references.

Modules are compared by their top-level name (the part before the first
dot) taken whole: ``moephoto_tpu_torch`` begins with ``moephoto_tpu`` and
is not the JAX package.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "moephoto_tpu"})
PROGRAM = "moephoto_tpu_torch"
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def topLevel(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Forbidden modules among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if topLevel(n) in FORBIDDEN)


def imports(path: str) -> List[str]:
    """Absolute module names a Python source imports."""
    with open(path, "r", encoding="utf-8") as fp:
        tree = ast.parse(fp.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def sources(sub: str = "") -> List[str]:
    out = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def sourceFaults() -> List[str]:
    """Imports the benchmark's sources may not make: a forbidden module
    anywhere, the program under ``reference/``."""
    faults = []
    for path in sources():
        rel = os.path.relpath(path, BENCH)
        for name in imports(path):
            top = topLevel(name)
            if top in FORBIDDEN or (top == PROGRAM and rel.startswith("reference" + os.sep)):
                faults.append(f"{rel} imports {name}")
    return faults
