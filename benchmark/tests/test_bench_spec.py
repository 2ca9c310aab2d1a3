"""The harness finds a cell's configuration, traffic mix, limits, driver
and metric readers by their names alone, and BENCHMARK.json keeps to its
contract's shape."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = spec.benchmarkFile()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.driver().Driver
        names = [m["name"] for m in cell.endToEnd + cell.perLayer]
        assert "setup_s" in names and len(cell.endToEnd) >= 2 and cell.perLayer
        for m in cell.endToEnd + cell.perLayer:
            assert callable(cell.reader(m["name"]).read)
        assert cell.limits["compare"]


def test_shape_of_benchmark_file():
    bench = spec.benchmarkFile()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for wl in m["workloads"]:  # each cell that reports it reports what it moves
            assert "workloads" not in e2e[m["moves"]] or wl in e2e[m["moves"]]["workloads"]
    assert 0.01 <= e2e["setup_s"]["bound"] <= 0.25


def test_a_new_cell_is_found_by_its_files(tmp_path, monkeypatch):
    """A configuration, a mix, a metric and a cell added as files and
    entries only, beside a copy of the benchmark."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    data = spec.benchmarkFile()
    cfg = json.loads((bench / "configs" / "moenet_lite2_x4.json").read_text())
    cfg["name"] = "lite_copy"
    (bench / "configs" / "lite_copy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_photos.json").write_text(json.dumps(
        {"kind": "images", "pool": 2, "sizes": [[32, 24]], "sample": 1}))
    (bench / "limits" / "lite_tiny.json").write_text(json.dumps({"compare": {"rms_lsb8": 1.0}}))
    (bench / "metrics" / "requests.image.py").write_text("def read(run):\n    return len(run.window.items)\n")
    data["configs"].append({"name": "lite_copy", "source": "x", "file": "benchmark/configs/lite_copy.json",
                            "reduced": [], "why": "a copy"})
    data["workloads"].append({"name": "lite_tiny", "config": "lite_copy", "traffic": "tiny_photos", "chips": 1,
                              "why": "tiny"})
    data["per_layer"].append({"name": "requests.image", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "pipeline steps", "moves": "image_mpx_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    monkeypatch.setattr(spec, "BENCH", str(bench))
    cell = spec.cell("lite_tiny", root=str(tmp_path))
    assert cell.config["name"] == "lite_copy" and cell.traffic["sizes"] == [[32, 24]]
    assert cell.limits["compare"] == {"rms_lsb8": 1.0}
    assert "requests.image" not in [m["name"] for m in cell.perLayer]  # its cell does not report image_mpx_s
    data["end_to_end"][1]["workloads"].append("lite_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = spec.cell("lite_tiny", root=str(tmp_path))
    assert "requests.image" in [m["name"] for m in cell.perLayer]

    class Run:
        class window:
            items = [1, 2, 3]

    assert cell.reader("requests.image").read(Run) == 3
    with pytest.raises(KeyError):
        spec.cell("no_such_cell", root=str(tmp_path))


def test_metric_files_match_names():
    bench = spec.benchmarkFile()
    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH, "metrics")) if f.endswith(".py")}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["name"] in files
