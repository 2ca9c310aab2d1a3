"""The port's spans and counters (``progress.span`` and ``progress.count``):
profiler ranges named ``moe.*`` at the steps, syncs, tile chunks and the
stream graph while the torch profiler records, and nothing otherwise."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from moephoto_tpu_torch import progress
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine import stream as S
from moephoto_tpu_torch.engine.executor import ModelExec
from moephoto_tpu_torch.engine.tiling import TileSpec, tiledApply
from moephoto_tpu_torch.parallel.mesh import makeMesh
from moephoto_tpu_torch.pipeline import steps
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.runtime.worker import begin
from moephoto_tpu_torch.utils import imageio
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

SPEC = TileSpec(tile=16, pad=2, align=4, scale=2, batch=4)
up2 = lambda t: t.repeat_interleave(2, 1).repeat_interleave(2, 2)


def events(prof):
    """(name, start, end) of the profile's ``moe.`` ranges, in order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("moe.")]
    return sorted(out, key=lambda e: (e[1], -e[2]))


def counted(evs, name):
    head = f"moe.count.{name}="
    return sum(int(n[len(head):]) for n, _, _ in evs if n.startswith(head))


@pytest.fixture
def chain(monkeypatch, tmp_path):
    """The image route's chain on the CPU with a 2x nearest-neighbour SR
    model on 16-pixel tiles: the file step takes the decoded array, the
    write step returns the array it would encode."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "opsPath", str(tmp_path / "ops.json"))
    monkeypatch.setattr(context, "getFile", lambda request: request)
    monkeypatch.setattr(imageio, "readFile", lambda image, ctx=None: image)
    monkeypatch.setattr(imageio, "writeFile", lambda image, name=None, ctx=None, *args: image)
    exec_ = ModelExec(up2, SPEC, dtype=torch.float32, device="cpu")
    monkeypatch.setitem(steps.stepOpts["SR"], "getOpt", lambda opt: exec_)

    def run(image):
        process, nodes = steps.genProcess([{"op": "file"}, {"op": "SR", "model": "lite", "scale": 2}])
        root = progress.Node({"op": "image"}, learn=0)
        return begin(root, nodes, -1).bindFunc(process)(image, name="t")

    return run


def test_chain_steps_nest_in_the_request(chain):
    """Each bound step is one ``moe.step.<op>`` range inside the request's
    ``moe.step.image``, in the chain's order; the tile chunk lies in the SR
    step's range."""
    image = np.random.RandomState(0).randint(0, 256, (12, 20, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = chain(image)
    assert out.shape == (24, 40, 3) and out.dtype == np.uint8
    evs = events(prof)
    (root,) = [e for e in evs if e[0] == "moe.step.image"]
    inside = lambda e, outer: outer[1] <= e[1] and e[2] <= outer[2]
    stepsRun = [e for e in evs if e[0].startswith("moe.step.") and e is not root]
    assert [e[0] for e in stepsRun] == ["moe.step.toTorch", "moe.step.SR", "moe.step.toFloat",
                                        "moe.step.toOutput", "moe.step.write"]
    assert all(inside(e, root) for e in stepsRun)
    (sr,) = [e for e in stepsRun if e[0] == "moe.step.SR"]
    chunks = [e for e in evs if e[0] == "moe.engine.chunk"]
    assert len(chunks) == 1 and inside(chunks[0], sr)
    assert not [e for e in evs if e[0] == "moe.sync"]  # the CPU needs none


@pytest.mark.parametrize("dtype, size", [(np.uint8, 1), (np.uint16, 2)])
def test_chain_counts_the_input_bytes_once(chain, dtype, size):
    """The image route records ``moe.count.in_bytes=<n>`` once a request,
    inside ``moe.step.toTorch``: the image's values x bytes a value."""
    image = np.zeros((12, 20, 3), dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chain(image)
    evs = events(prof)
    counts = [e for e in evs if e[0].startswith("moe.count.in_bytes=")]
    (toTorch,) = [e for e in evs if e[0] == "moe.step.toTorch"]
    assert [e[0] for e in counts] == [f"moe.count.in_bytes={image.size * size}"]
    assert toTorch[1] <= counts[0][1] and counts[0][2] <= toTorch[2]


def test_video_output_steps_nest_in_one_range(monkeypatch):
    """The video route's output steps of a frame, and the count of the
    bytes its copy moves (4 x 6 x 3 values of 2 bytes), lie in one
    ``moe.step.output``; the input step before it does not."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(context, "root", progress.Node({"op": "video"}, learn=0))
    process, _ = steps.genProcess([{"op": "buffer", "bitDepth": 16}, {"op": "output"}])
    raw = (np.arange(4 * 6 * 3, dtype=np.uint16) * 100).reshape(4, 6, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (out,) = process((raw.tobytes(), 4, 6))
    assert out == raw.tobytes()
    evs = events(prof)
    assert [e[0] for e in evs] == ["moe.step.toTorch", "moe.step.output", "moe.step.toFloat",
                                   "moe.step.toOutput", "moe.count.out_bytes=144", "moe.step.toBuffer"]
    assert evs[0][2] <= evs[1][1] and all(evs[1][1] <= e[1] and e[2] <= evs[1][2] for e in evs[2:])


def test_chain_counts_the_padded_chunk(chain):
    """12 x 20 pixels on 16-pixel tiles with a 2-pixel halo: 1 x 2 tiles,
    one chunk padded to the batch of 4."""
    image = np.zeros((12, 20, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chain(image)
    evs = events(prof)
    assert counted(evs, "tiles_needed") == 2 and counted(evs, "tiles_run") == 4


@pytest.mark.parametrize("mesh, chunks", [(None, 3), (2, 2)])
def test_tiles_run_counts_every_padded_model_call(mesh, chunks):
    """5 tiles in batches of 2: single-device chunks of 2, 2 and 1 tiles
    run 6; on a mesh of 2 a chunk of 4 runs 4 and the last, one device's
    tile, runs 2."""
    spec = TileSpec(tile=16, pad=2, align=4, scale=2, batch=2)
    x = torch.rand(12, 64, 3)  # anchors at 0, 12, 24, 36, 48
    m = makeMesh([mesh], devices=["cpu"] * mesh) if mesh else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = tiledApply(x, up2, spec, mesh=m)
    torch.testing.assert_close(y, up2(x[None])[0])
    evs = events(prof)
    assert len([e for e in evs if e[0] == "moe.engine.chunk"]) == chunks
    assert counted(evs, "tiles_needed") == 5 and counted(evs, "tiles_run") == 6


def test_sync_range_once_per_synchronise(monkeypatch):
    """``moe.sync`` wraps each synchronise ``settle`` makes (a result off
    the CPU) and no other call; the step's range holds it."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    onDevice = progress.Node({"op": "SR", "model": "t"}).bindFunc(lambda: torch.empty(2, device="meta"))
    onHost = progress.Node({"op": "toFloat"}).bindFunc(lambda: torch.zeros(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        onDevice()
        onHost()
        onDevice()
    evs = events(prof)
    names = [e[0] for e in evs]
    assert len(calls) == names.count("moe.sync") == 2
    assert names == ["moe.step.SR", "moe.sync", "moe.step.toFloat", "moe.step.SR", "moe.sync"]
    for step, sync in ((evs[0], evs[1]), (evs[3], evs[4])):
        assert step[1] <= sync[1] and sync[2] <= step[2]


def test_stream_graph_pass_is_one_range():
    g = S.StreamGraph()
    src, out = S.Stream(), S.Stream(store=False)
    out.sink = []
    g.stage(lambda x, last=None: [x[i] * 2 for i in range(x.shape[0])], [src], [out], size=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(3):
            src.put([torch.full((2,), float(t))])
            g.run()
        g.run(last=True)
    assert [e[0] for e in events(prof)] == ["moe.stream.run"] * 4
    assert [float(o[0]) for o in out.sink] == [0.0, 2.0, 4.0]


@pytest.mark.parametrize("define, name", [({"op": "SR", "model": "lite", "scale": 4}, "moe.step.SR"),
                                          ({"IFRNet": "encode"}, "moe.step.IFRNet.encode"),
                                          ({}, "moe.step.node")])
def test_step_names(define, name):
    assert progress.stepName(define) == name


def test_profiler_off_builds_no_range(monkeypatch):
    """Off, neither helper constructs a ``record_function``; on, both do
    (so the patch below is the one they would call)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with progress.span("moe.step.x"):
        progress.count("tiles_run", 4)
    assert progress.Node({"op": "toFloat"}).bindFunc(lambda: 3)() == 3
    tiledApply(torch.rand(12, 20, 3), up2, SPEC)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="moe.step.x"):
            progress.span("moe.step.x")
        with pytest.raises(AssertionError, match="moe.count.tiles_run=4"):
            progress.count("tiles_run", 4)
