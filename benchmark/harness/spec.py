"""``BENCHMARK.json`` and the files it names, found by name alone.

A cell's configuration is ``benchmark/configs/<config>.json``, its
traffic ``benchmark/traffic/<traffic>.json``, the limits of its
correctness check ``benchmark/limits/<workload>.json``; the driver of the
chain a configuration runs is ``benchmark/drivers/<entry>.py`` and each
metric's reader ``benchmark/metrics/<metric>.py``.  So a later change
adds a configuration, a mix, a cell or a metric by adding files and
entries, never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fp:
        return json.load(fp)


def loadFile(path: str, name: str) -> ModuleType:
    """Import ``path`` as a module of its own (metric files carry dots in
    their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cellMetrics(metrics: List[dict], workload: str, reports=None) -> List[dict]:
    """The metrics a cell reports: those that name it under ``workloads``
    and those without the key (reported wherever the metric they move is,
    for a per-layer metric)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reports is None or m.get("moves") in reports:
            out.append(m)
    return out


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    endToEnd: List[dict]
    perLayer: List[dict]

    def driver(self) -> ModuleType:
        entry = self.config["entry"]
        return loadFile(os.path.join(BENCH, "drivers", f"{entry}.py"), f"benchmark.drivers.{entry}")

    def reader(self, metric: str) -> ModuleType:
        return loadFile(os.path.join(BENCH, "metrics", f"{metric}.py"),
                        "benchmark.metrics." + metric.replace(".", "__"))


def benchmarkFile(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmarkFile(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(os.path.join(root, cfgs[w["config"]]["file"]))
    traffic = _json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(BENCH, "limits", f"{name}.json"))
    e2e = _cellMetrics(bench["end_to_end"], name)
    perLayer = _cellMetrics(bench["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name, w, cfg, traffic, limits, e2e, perLayer)
