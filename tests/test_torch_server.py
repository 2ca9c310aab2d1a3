"""The port's product surface on the CPU: its HTTP server
(moephoto_tpu_torch/runtime/server.py) case for case as
tests/test_server.py holds the JAX package's, with the same echo worker
and stubbed pipes; the port's real worker loop (runtime/worker.py and
app_torch.routes) over real pipes and shared memory; and the
two-process app (app_torch.py) started as a user starts it."""

import contextlib
import io
import json
import mmap
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import uuid
from multiprocessing import Event, Pipe
from multiprocessing.shared_memory import SharedMemory

import numpy as np
import pytest
import torch
from PIL import Image

import app_torch
from moephoto_tpu_torch import cli
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline import registry
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.runtime.worker import worker
from moephoto_tpu_torch.synth import synthLite2Params
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [{"op": "SR", "model": "lite", "scale": 2}]


class FakePipe:
    """One end of a worker pipe pair."""

    def __init__(self):
        self.items = []
        self.cv = threading.Condition()

    def send(self, item):
        with self.cv:
            self.items.append(item)
            self.cv.notify_all()

    def poll(self, timeout=0):
        with self.cv:
            if not self.items:
                self.cv.wait(timeout or 0)
            return bool(self.items)

    def recv(self):
        # blocks until data, like a real mp.Pipe end
        with self.cv:
            while not self.items:
                self.cv.wait()
            return self.items.pop(0)


class FakeEvent:
    def __init__(self):
        self._s = False

    def is_set(self):
        return self._s

    def set(self):
        self._s = True

    def clear(self):
        self._s = False


class FakeSHM:
    """SharedMemory stand-in: anonymous mmap (buf.obj seek/write like the
    real thing)."""

    def __init__(self, size=1 << 20):
        self.buf = memoryview(mmap.mmap(-1, size))


def pngBytes(h, w, seed):
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def echoServer(S):
    """``S.runserver`` over fake pipes whose echo worker replies with a
    canned success for any task; the tasks it got are kept in order."""
    sender, receiver, noter = FakePipe(), FakePipe(), FakePipe()
    done, tasks = threading.Event(), []

    def workerThread():
        while not done.is_set():
            if sender.poll(0.05):
                task = sender.recv()
                tasks.append(task)
                receiver.send(({"result": "ok", "task": task[0]}, 200))

    t = threading.Thread(target=workerThread, daemon=True)
    t.start()
    S.runserver(sender, receiver, noter, FakeEvent(), FakeSHM(), False)
    S.current.session = None
    S.current.key = None
    return t, done, tasks


@pytest.fixture()
def client():
    """The port's server and the JAX package's, each over its own fake
    pipes and echo worker, as tests/test_server.py sets up the latter."""
    import moephoto_tpu.runtime.server as jaxServer
    import moephoto_tpu_torch.runtime.server as S
    from werkzeug.test import Client

    servers = [(Client(m.app), m, *echoServer(m)) for m in (S, jaxServer)]
    yield Servers([(c, m, tasks) for c, m, _, _, tasks in servers])
    for _, _, t, done, _ in servers:
        done.set()
        t.join(5)


class Servers:
    """The port's server and the JAX package's, side by side."""

    def __init__(self, servers):
        self.servers = servers
        self.port, self.S, self.tasks = servers[0]

    def both(self, request):
        """(status, body) of ``request(client, serverModule)`` on the port's
        server and on the JAX package's; the body parsed as JSON where it
        is JSON."""
        out = []
        for c, S, _ in self.servers:
            resp = request(c, S)
            data = resp.get_data()
            try:
                body = json.loads(data)
            except ValueError:
                body = data
            out.append((resp.status_code, body))
        return out

    def holding(self, session):
        """Set ``current`` of both servers as while ``session`` runs."""
        for _, S, _ in self.servers:
            S.current.session = session
            S.current.path = "/video_enhance"
            S.current.key = S.current.path + session

    def release(self):
        for _, S, _ in self.servers:
            S.current.session = None
            S.current.key = None


# --- the 11 cases of tests/test_server.py: the port's server replies as the
# JAX package's does to the same request --------------------------------------

def test_page_root(client):
    port, jax = client.both(lambda c, S: c.get("/"))
    assert port[0] in (200, 404)  # 200 when the frontend is found
    assert port == jax


def test_system_info(client):
    port, jax = client.both(lambda c, S: c.post("/systemInfo", data={"session": "s1"}))
    assert port == jax == (200, {"result": "ok", "task": "systemInfo"})


def test_session_gate_busy(client):
    client.holding("other")
    try:
        port, jax = client.both(lambda c, S: c.post("/systemInfo", data={"session": "s2"}))
    finally:
        client.release()
    assert port[0] == 503 and port == jax


def test_image_enhance_roundtrip(client):
    """The same reply, and the same task on the worker pipe: the image's
    size and the steps with the output named after the upload."""
    port, jax = client.both(lambda c, S: c.post(
        "/image_enhance",
        data={
            "session": "s3",
            "steps": json.dumps(STEPS),
            "file": (io.BytesIO(pngBytes(8, 8, 0)), "test.png"),
        },
    ))
    assert port == jax == (200, {"result": "ok", "task": "image_enhance"})
    (portTask,), (jaxTask,) = (tasks for _, _, tasks in client.servers)
    assert portTask == jaxTask
    assert portTask[0] == "image_enhance" and portTask[-1]["file"].endswith("/test.png")


def test_stop_endpoint(client):
    port, jax = client.both(lambda c, S: c.post("/stop", data={"session": "sX"}))
    # no current session -> 404 per the control point table
    assert port[0] == 404 and port == jax


def test_preset_endpoint(client):
    port, jax = client.both(lambda c, S: c.get("/preset", query_string={"path": "video"}))
    assert port[0] == 200 and isinstance(port[1], list)
    assert port == jax


def test_preset_rejects_bad_path(client):
    port, jax = client.both(lambda c, S: c.get("/preset", query_string={"path": "../etc"}))
    assert port[0] == 403 and port == jax


def test_static_traversal_blocked(client):
    # a secret outside every static root must not be reachable
    for url in (
        "/static/../../../etc/passwd",
        "/static/..%2f..%2f..%2fetc/passwd",
        "/download/../tests/test_torch_server.py",
        "/download/../../etc/passwd",
    ):
        port, jax = client.both(lambda c, S: c.get(url))
        assert port[0] == 404 and port == jax, url


def test_static_legit_download(client):
    S = client.S
    os.makedirs(S.outDir, exist_ok=True)
    p = os.path.join(S.outDir, "ok_torch.txt")
    with open(p, "w") as f:
        f.write("fine")
    try:
        port, jax = client.both(lambda c, S: c.get("/" + S.outDir + "/ok_torch.txt"))
    finally:
        os.remove(p)
    assert port == jax == (200, b"fine")


def test_bench_note_end_to_end(client):
    """A bench note walks the whole pipe: a bench-mode progress Node of the
    port learns an op weight with the fields a JAX Node's note has, the
    worker-side callback payload lands in the server's note cache, and
    GET /msg hands the client the {op, weight, samples} fields the
    frontend's bench table reads, as the JAX server hands them."""
    from moephoto_tpu import progress as jaxProgress
    from moephoto_tpu_torch import progress as P

    def benchNote(progress):
        notes = []
        root = progress.Node({"op": "SR", "model": "lite", "scale": 2}, load=100, learn=1)
        root.setCallback(lambda node, info: notes.append(dict(info)), bench=True)
        root.reset()
        root.trace(0)
        time.sleep(0.01)
        root.trace()
        benched = [n for n in notes if "weight" in n]
        assert benched, notes
        return benched[-1]

    note, jaxNote = benchNote(P), benchNote(jaxProgress)
    assert note.keys() == jaxNote.keys() and note["op"] == jaxNote["op"]
    assert note["op"]["op"] == "SR" and note["samples"] >= 1
    assert note["weight"] > 0

    client.holding("sb")
    try:
        for _, S, _ in client.servers:
            S.updateNote(S.current.key, dict(note))
        port, jax = client.both(lambda c, S: c.get("/msg", query_string={"session": "sb", "path": "/video_enhance"}))
    finally:
        client.release()
    assert port == jax
    status, got = port
    assert status == 200
    assert got["op"]["op"] == "SR"
    assert got["weight"] == pytest.approx(note["weight"])
    assert got["samples"] == note["samples"]
    mark = 3e-5 / max(got["weight"], 1e-12)  # the frontend's bench score
    assert mark > 0


def test_session_acquire_is_atomic(client):
    """Racing enhance POSTs: each one is served or told Busy, never an
    error, on both servers; a served one gets the JAX server's reply."""
    import concurrent.futures as cf

    for c, S, _ in client.servers:
        with cf.ThreadPoolExecutor(8) as ex:
            resps = list(ex.map(lambda i: c.post("/systemInfo", data={"session": f"race{i}"}), range(8)))
        assert {r.status_code for r in resps} <= {200, 503}
        served = [json.loads(r.get_data()) for r in resps if r.status_code == 200]
        assert served and all(b == {"result": "ok", "task": "systemInfo"} for b in served)


def test_client_file_names_stay_in_their_directories(client, tmp_path):
    """An upload named ``../x.png`` (or with a directory) writes nothing
    outside ``uploadDir`` or ``outDir``: the port keeps its base name,
    refuses a name that leaves nothing, and refuses steps whose output
    file lies outside ``outDir``.  The JAX server takes the name as
    given."""
    S = client.S
    tag = uuid.uuid4().hex[:8]

    def post(path, name, steps=STEPS):
        data = {"session": "f" + tag, "steps": json.dumps(steps), "file": (io.BytesIO(pngBytes(8, 8, 1)), name)}
        return client.port.post(path, data=data)

    resp = post("/image_enhance", f"../../{tag}.png")
    assert resp.status_code == 200
    assert client.tasks[-1][-1]["file"] == f"{S.outDir}/{tag}.png"
    resp = post("/video_enhance", f"../{tag}.mkv")
    assert resp.status_code == 200
    try:
        assert client.tasks[-1][1] == f"{S.uploadDir}/{tag}.mkv" and os.path.isfile(client.tasks[-1][1])
        assert client.tasks[-1][-1]["file"] == f"{S.outDir}/{tag}.mkv"
    finally:
        os.remove(client.tasks[-1][1])
    assert not os.path.exists(f"{tag}.png") and not os.path.exists(f"{tag}.mkv")
    sent = len(client.tasks)
    for path, name, steps in (("/image_enhance", "..", STEPS), ("/video_enhance", "../", STEPS),
                              ("/image_enhance", "in.png", STEPS + [{"op": "output", "file": str(tmp_path / "x.png")}]),
                              ("/image_enhance", "in.png", STEPS + [{"op": "output", "file": f"{S.outDir}/../x.png"}])):
        resp = post(path, name, steps)
        assert resp.status_code == 400, (path, name, steps)
    resp = client.port.post("/batch_enhance", data={"session": "b" + tag, "steps": json.dumps(STEPS), "file": [
        (io.BytesIO(pngBytes(8, 8, 2)), "ok.png"), (io.BytesIO(pngBytes(8, 8, 3)), "/")]})
    assert resp.status_code == 400
    assert len(client.tasks) == sent and not os.listdir(tmp_path)
    resp = post("/image_enhance", "in.png", STEPS + [{"op": "output", "file": f"{S.outDir}/named.png"}])
    assert resp.status_code == 200 and client.tasks[-1][-1]["file"] == f"{S.outDir}/named.png"


def test_notes_pipe_has_one_reader_across_back_to_back_sessions(monkeypatch):
    """Back-to-back sessions over a real notes pipe: each session's note
    reader is gone before its reply, so no two threads ever read the pipe
    at once (the JAX server's reader outlives its session when the next
    one starts at once, and two readers tear the pipe's messages apart),
    and every session's notes reach /msg."""
    import moephoto_tpu_torch.runtime.server as S
    from werkzeug.test import Client

    sender, receiver = FakePipe(), FakePipe()
    noteRx, noteTx = Pipe(False)
    done, errors = threading.Event(), []
    monkeypatch.setattr(threading, "excepthook", lambda a: errors.append(a.exc_value))

    def workerThread():  # three progress notes, then the reply
        while not done.is_set():
            if sender.poll(0.05):
                task = sender.recv()
                for i in range(3):
                    noteTx.send({"eta": 3 - i, "gone": i, "total": 3, "pad": "x" * 50000})
                receiver.send(({"result": "ok", "task": task[0]}, 200))

    t = threading.Thread(target=workerThread, daemon=True)
    t.start()
    S.runserver(sender, receiver, noteRx, FakeEvent(), FakeSHM(), False)
    S.current.session = S.current.key = None
    c = Client(S.app)
    try:
        for i in range(20):
            resp = c.post("/systemInfo", data={"session": f"b{i}"})
            assert resp.status_code == 200
            assert not [th for th in threading.enumerate() if th.name == "pollNote"]
    finally:
        done.set()
        t.join(5)
    assert not errors, errors


# --- the real worker loop ---------------------------------------------------

@contextlib.contextmanager
def cpuModels(modelDir):
    """The port on the CPU reading ``modelDir``, with empty model caches;
    the config and the caches are restored afterwards."""
    saved = dict(config.__dict__), dict(registry._modelCache), dict(registry._paramsCache)
    registry._modelCache.clear()
    registry._paramsCache.clear()
    config.device, config.modelDir = "cpu", str(modelDir)
    try:
        yield
    finally:
        config.__dict__.update(saved[0])
        for cache, old in zip((registry._modelCache, registry._paramsCache), saved[1:]):
            cache.clear()
            cache.update(old)


@pytest.fixture()
def live(tmp_path, monkeypatch):
    """The port's ``worker`` in a thread over real pipes, a real stop event
    and a real shared-memory block, serving ``app_torch.routes()`` on the
    CPU with synth lite x2 weights; the context, config and caches are
    restored afterwards."""
    (tmp_path / "lite").mkdir()
    torch.save(synthLite2Params(2, seed=5), str(tmp_path / "lite" / "model.pth"))
    monkeypatch.setattr(config, "opsPath", str(tmp_path / "ops.json"))
    monkeypatch.setattr(config, "logPath", str(tmp_path / "log.txt"))
    for key in ("root", "shared", "sharedView", "notifier", "stopFlag", "imageMode", "palette"):
        monkeypatch.setattr(context, key, getattr(context, key))
    with cpuModels(tmp_path):
        yield from _serving(tmp_path)


def _serving(tmp_path, worker=worker, routes=app_torch.routes, context=context):
    """``worker`` in a thread serving ``routes()`` over real pipes, a real
    stop event and a real shared-memory block; yields the means to call it."""
    shm = SharedMemory(f"moe_test_{uuid.uuid4().hex[:12]}", True, 1 << 20)
    taskRx, taskTx = Pipe(False)
    resultRx, resultTx = Pipe(False)
    noteRx, noteTx = Pipe(False)
    stop = Event()

    def serve():
        try:
            worker(lambda: (shm, routes()), taskRx, resultTx, noteTx, stop, False)
        except EOFError:  # the task pipe closed: the test is over
            pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    def call(name, *args, timeout=60):
        taskTx.send((name, *args))
        assert resultRx.poll(timeout), f"no reply to {name} within {timeout} s"
        return resultRx.recv()

    def put(data):
        shm.buf[: len(data)] = data
        return len(data)

    yield dict(call=call, put=put, stop=stop, notes=noteRx, dir=tmp_path)
    taskTx.close()
    t.join(10)
    assert not t.is_alive()
    context.shared = context.sharedView = None  # drop the views before the block closes
    shm.close()
    shm.unlink()


def test_worker_image_enhance_equals_cli_run_image(live):
    """``image_enhance`` through the real worker loop writes the same PNG,
    byte for byte, as ``cli.runImage`` on the same input and steps."""
    d = live["dir"]
    data = pngBytes(16, 16, 3)
    (d / "in.png").write_bytes(data)
    body, status = live["call"]("image_enhance", live["put"](data), *STEPS, {"op": "output", "file": str(d / "w.png")})
    assert (body, status) == ({"result": str(d / "w.png")}, 200)
    cli.runImage(str(d / "in.png"), str(d / "c.png"), STEPS)
    assert (d / "w.png").read_bytes() == (d / "c.png").read_bytes()
    assert Image.open(d / "w.png").size == (32, 32)
    notes = []
    while live["notes"].poll():
        notes.append(live["notes"].recv())
    assert notes and all("eta" in n for n in notes), notes


@pytest.fixture()
def jaxLive(tmp_path, monkeypatch):
    """The JAX package's ``worker`` in a thread serving ``app.py``'s routes
    on the CPU, as ``live`` serves the port's, with the same synth lite x2
    weights; its context, config and caches are restored afterwards."""
    import importlib

    import app
    import moephoto_tpu.runtime.worker as jaxWorker
    from moephoto_tpu.pipeline import registry as jaxRegistry
    from moephoto_tpu.runtime.context import context as jaxContext

    jaxConfigModule = importlib.import_module("moephoto_tpu.config")  # the package's 'config' is the object
    d = tmp_path / "jax"
    (d / "lite").mkdir(parents=True)
    torch.save(synthLite2Params(2, seed=5), str(d / "lite" / "model.pth"))
    monkeypatch.setattr(jaxWorker, "opsPath", str(d / "ops.json"))
    monkeypatch.setattr(jaxConfigModule, "enableCompilationCache", lambda *a: None)
    monkeypatch.setattr(jaxConfigModule.config, "modelDir", str(d))
    monkeypatch.setattr(app, "openShared", lambda create: None)  # _serving gives the worker its block
    for key in ("root", "shared", "sharedView", "notifier", "stopFlag", "imageMode", "palette"):
        monkeypatch.setattr(jaxContext, key, getattr(jaxContext, key))
    caches = jaxRegistry._modelCache, jaxRegistry._paramsCache
    saved = [dict(c) for c in caches]
    for cache in caches:
        cache.clear()
    try:
        yield from _serving(d, jaxWorker.worker, lambda: app.main()[1], jaxContext)
    finally:
        for cache, old in zip(caches, saved):
            cache.clear()
            cache.update(old)


def test_worker_image_enhance_matches_the_jax_worker(live, jaxLive):
    """The same 16x16 PNG through the port's worker loop and the JAX
    package's, each serving its app's routes with the same synth lite x2
    weights: the same reply form, PNGs within 1 LSB (the two packages'
    fp32 results differ by ~1e-5 and may round apart); a malformed image
    gets the same failure reply, the same call described and no 'opt'."""
    data = pngBytes(16, 16, 3)
    replies, images = [], []
    for side, tag in ((live, "port"), (jaxLive, "jax")):
        out = str(side["dir"] / f"{tag}.png")
        body, status = side["call"]("image_enhance", side["put"](data), *STEPS, {"op": "output", "file": out})
        assert (body, status) == ({"result": out}, 200)
        images.append(np.asarray(Image.open(out)).astype(np.int32))
        steps = [dict(s) for s in STEPS] + [{"op": "output", "file": str(side["dir"] / "bad.png")}]
        body, status = side["call"]("image_enhance", side["put"](b"not a png at all"), *steps)
        call = json.loads(json.dumps(body["call"]).replace(str(side["dir"]), ""))
        replies.append((status, sorted(body), body["result"], call))
    assert images[0].shape == images[1].shape == (32, 32, 3)
    assert np.abs(images[0] - images[1]).max() <= 1
    assert replies[0] == replies[1]
    assert replies[0][:3] == (400, ["call", "exception", "result"], "Fail")
    assert replies[0][3][0] == "runImageTask" and all("opt" not in s for s in replies[0][3][2:])


def test_worker_failure_reply_pickles_and_next_request_succeeds(live):
    """A malformed image fails after genProcess attached a ModelExec
    ('opt') to the step dicts: the reply is ``({"result": "Fail", ...},
    400)``, it crossed a real pipe (so it pickles), it holds no 'opt', and
    the loop serves the next request."""
    d = live["dir"]
    steps = [dict(s) for s in STEPS] + [{"op": "output", "file": str(d / "bad.png")}]
    body, status = live["call"]("image_enhance", live["put"](b"not a png at all"), *steps)
    assert status == 400 and body["result"] == "Fail"
    assert "UnidentifiedImageError" in body["exception"] or "cannot identify" in body["exception"]
    assert body["call"][0] == "runImageTask" and all("opt" not in s for s in body["call"][2:])
    assert pickle.loads(pickle.dumps(body)) == body
    assert live["notes"].poll(5)
    notes = []
    while live["notes"].poll():
        notes.append(live["notes"].recv())
    assert any(n.get("result") == "Fail" for n in notes)
    body, status = live["call"]("image_enhance", live["put"](pngBytes(16, 16, 4)), *STEPS,
                                {"op": "output", "file": str(d / "good.png")})
    assert status == 200 and os.path.exists(body["result"])


def test_worker_lock_interface_returns_remaining_seconds_on_stop(live):
    """``lockInterface`` counts down until the stop event is set, then
    returns the seconds it had left."""
    replied = threading.Event()

    def stopper():  # the loop clears the event when the task arrives: set it until the reply
        while not replied.wait(0.3):
            live["stop"].set()

    threading.Thread(target=stopper, daemon=True).start()
    t0 = time.monotonic()
    try:
        remain = live["call"]("lockInterface", 30)
    finally:
        replied.set()
    assert 25 <= remain < 30 and time.monotonic() - t0 < 5


def test_worker_system_info_on_cpu(live):
    """On the CPU the reply keeps JAX's form: one entry, 0 MiB (no memory
    stats)."""
    assert live["call"]("systemInfo") == ({"result": [0]}, 200)


def test_worker_main_raises_without_cuda(monkeypatch):
    """The app's worker asks for CUDA unless its config asks for the CPU,
    and raises without it."""
    monkeypatch.setattr(config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        app_torch.main(app_torch.shmName(os.getpid()))


# --- the two-process app ----------------------------------------------------

def freePort():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multipart(fields, files):
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode())
    for k, (name, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{name}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'.encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def procStat(pid):
    """(state, parent pid) of a process, or None when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as fp:
            fields = fp.read().rsplit(")", 1)[1].split()
    except (FileNotFoundError, ProcessLookupError):
        return None
    return fields[0], int(fields[1])


def childPids(pid):
    return [int(p) for p in os.listdir("/proc") if p.isdigit() and (procStat(p) or ("", 0))[1] == pid]


def alive(pid):
    st = procStat(pid)
    return st is not None and st[0] != "Z"


def test_two_process_app_serves_an_image(tmp_path):
    """``python3 app_torch.py`` from a directory whose .user/config.json asks
    for the CPU: it answers an /image_enhance over a socket with the output
    ``cli.runImage`` writes, its shared-memory block is named after its
    process and sized by ``sharedMemSize``, it shuts down on SIGINT, leaves
    no child process behind, and its block is gone (within 120 s)."""
    deadline = time.monotonic() + 120
    (tmp_path / "model" / "lite").mkdir(parents=True)
    torch.save(synthLite2Params(2, seed=7), str(tmp_path / "model" / "lite" / "model.pth"))
    (tmp_path / ".user").mkdir()
    port = freePort()
    (tmp_path / ".user" / "config.json").write_text(json.dumps(
        {"device": "cpu", "port": port, "modelDir": str(tmp_path / "model"), "sharedMemSize": [1 << 22]}))
    data = pngBytes(16, 16, 9)
    (tmp_path / "in.png").write_bytes(data)
    log = open(tmp_path / "app.log", "wb")
    app = subprocess.Popen([sys.executable, os.path.join(ROOT, "app_torch.py")], cwd=str(tmp_path),
                           stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        while True:
            assert app.poll() is None, (tmp_path / "app.log").read_text()
            try:
                with urllib.request.urlopen(base + "/", timeout=5) as r:
                    r.read()
                break
            except urllib.error.HTTPError:  # 404: no frontend under this cwd, but it answers
                break
            except OSError:
                assert time.monotonic() < deadline, "the app did not answer"
                time.sleep(0.2)
        body, ctype = multipart({"session": "p1", "steps": json.dumps(STEPS)}, {"file": ("in.png", data)})
        req = urllib.request.Request(base + "/image_enhance", data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=max(1, deadline - time.monotonic())) as r:
            reply = json.loads(r.read())
        assert reply == {"result": "download/in.png"}
        assert os.stat("/dev/shm/" + app_torch.shmName(app.pid)).st_size == 1 << 22
        children = childPids(app.pid)
        assert children, "no worker process"
        app.send_signal(signal.SIGINT)
        app.wait(max(1, deadline - time.monotonic()))
        while any(alive(p) for p in children) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(alive(p) for p in children), "a child process outlived the app"
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()
        log.close()
        try:  # the app unlinks its block on the way out; a killed one leaves it
            SharedMemory(app_torch.shmName(app.pid)).unlink()
            leftBlock = True
        except FileNotFoundError:
            leftBlock = False
    assert not leftBlock, "the app left its shared-memory block"
    with cpuModels(tmp_path / "model"):
        cli.runImage(str(tmp_path / "in.png"), str(tmp_path / "cli.png"), STEPS)
    assert (tmp_path / "download" / "in.png").read_bytes() == (tmp_path / "cli.png").read_bytes()
