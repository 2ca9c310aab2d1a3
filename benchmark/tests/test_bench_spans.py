"""The readers of the program's own spans and counters (``harness/spans.py``
and the metrics that use it), on synthetic traces, and on short traced
runs of each cell on the CPU."""

import pytest

from benchmark.harness import spans
from benchmark.harness.cell import Item, Run, Window
from benchmark.harness.trace import WINDOW, Trace
from benchmark.harness.spec import cell
from benchmark.tests.helpers import runTiny, tinyCell

NEW = {
    "image": ["output_host_ms.image", "sync_ms.image", "syncs.image", "engine_host_ms.image", "tile_use.image"],
    "video": ["output_host_ms.video", "sync_ms.video", "syncs.video", "stream_host_ms.video"],
}


def run(host, items=2, window=(10.0, 20.0)):
    """A traced run of ``items`` completed items whose window is ``window``
    (seconds) and whose host events are ``host``."""
    trace = Trace(window, [], [(WINDOW, *window)] + list(host))
    return Run(1.0, Window(*window, [Item(window[0], window[1]) for _ in range(items)]), trace)


def read(name, r):
    return cell("slomo_ifrnet_m_1080p" if name.endswith(".video") else "sr_lite4_1080p").reader(name).read(r)


@pytest.mark.parametrize("name", NEW["image"] + NEW["video"])
def test_none_without_program_events(name):
    """A program that records no ``moe.`` event: every reader reads
    None there, and on an untraced run, not 0."""
    assert read(name, run([("aten::to", 11.0, 12.0), ("bench.request", 10.0, 15.0)])) is None
    assert read(name, Run(1.0, Window(0.0, 1.0, [Item(0.0, 1.0)]))) is None
    assert read(name, run([("moe.sync", 30.0, 31.0)])) is None  # after the window


def test_spans_are_clipped_to_the_window():
    host = [("moe.step.toOutput", 9.0, 10.5),  # 0.5 s inside
            ("moe.step.toOutput", 12.0, 13.0),
            ("moe.step.Channel", 12.5, 13.5),  # overlaps the one before: counted once
            ("moe.step.toBuffer", 19.5, 21.0),  # 0.5 s inside
            ("moe.step.toFloat", 14.0, 15.0),  # not an output step
            ("moe.sync", 14.0, 14.25), ("moe.sync", 21.0, 22.0)]
    r = run(host)
    assert read("output_host_ms.image", r) == pytest.approx((0.5 + 1.5 + 0.5) / 2 * 1e3)
    assert read("output_host_ms.video", r) == pytest.approx((0.5 + 1.5 + 0.5) / 2 * 1e3)
    assert read("sync_ms.image", r) == pytest.approx(0.25 / 2 * 1e3)
    assert read("syncs.image", r) == 0.5 and read("syncs.video", r) == 0.5
    assert read("engine_host_ms.image", r) == 0.0  # program events, but no chunk
    assert read("tile_use.image", r) is None  # no counter to read


def test_counts_are_parsed_and_summed():
    host = [("moe.engine.chunk", 11.0, 11.5), ("moe.count.tiles_needed=10", 11.1, 11.1),
            ("moe.count.tiles_run=10", 11.1, 11.1),
            ("moe.engine.chunk", 12.0, 12.25), ("moe.count.tiles_needed=3", 12.1, 12.1),
            ("moe.count.tiles_run=10", 12.1, 12.1),
            ("moe.count.tiles_needed=7", 25.0, 25.0), ("moe.count.tiles_run=1000", 25.0, 25.0)]  # after the window
    r = run(host)
    assert spans.counts(spans.inWindow(r), "tiles_needed") == [10, 3]
    assert spans.counts(spans.inWindow(r), "tiles_run") == [10, 10]
    assert read("tile_use.image", r) == pytest.approx(65.0)
    assert read("engine_host_ms.image", r) == pytest.approx(0.75 / 2 * 1e3)


def test_stream_self_time_leaves_out_the_steps_it_runs():
    host = [("moe.stream.run", 11.0, 12.0),
            ("moe.step.IFRNet.encode", 11.1, 11.4), ("moe.step.IFRNet.decode", 11.5, 11.9),
            ("moe.stream.run", 13.0, 13.5),  # a pass that runs no step
            ("moe.step.toOutput", 12.0, 12.8),  # after the pass: not its child
            ("moe.stream.run", 19.8, 21.0), ("moe.step.IFRNet.decode", 19.9, 20.5)]  # cut by the window's end
    r = run(host, items=4)
    self_s = (1.0 - 0.7) + 0.5 + (0.2 - 0.1)
    assert read("stream_host_ms.video", r) == pytest.approx(self_s / 4 * 1e3)
    assert spans.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["sr_lite4_1080p", "slomo_ifrnet_m_1080p"])
def test_a_traced_run_reports_the_new_metrics(name, tmp_path):
    """A short traced run of the cell on the CPU: every new metric reads,
    and on one tile an image, in one chunk of 10, the tiles needed are a
    tenth of those run; the CPU needs no sync."""
    from benchmark.harness.cell import readMetrics

    _, _, r = runTiny(name, tmp_path, seconds=0.3, traced=True)
    metrics = readMetrics(tinyCell(name), r, True)
    kind = "video" if "slomo" in name else "image"
    assert set(NEW[kind]) <= set(metrics)
    assert metrics[f"syncs.{kind}"]["value"] == 0.0
    if kind == "image":
        assert metrics["tile_use.image"]["value"] == pytest.approx(10.0)
        assert metrics["engine_host_ms.image"]["value"] > 0
    else:
        assert metrics["stream_host_ms.video"]["value"] > 0
