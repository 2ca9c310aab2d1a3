"""HTTP server of the two-process app: the endpoints ``/image_enhance``,
``/video_enhance``, ``/batch_enhance``, the ``/msg`` long-poll, ``/stop``,
``/preset``, ``/systemInfo``, ``/lockInterface``, ``/log``, the pages and
the downloads, so the shared frontend under ``templates/`` and
``static/`` and the ``static/api.js`` client work unchanged.

Built on werkzeug's threaded WSGI server and jinja2; long-polls wait on
events in threads.  This process never touches CUDA: the worker owns the
card, so the system page takes device names from ``nvidia-smi``.
"""

from __future__ import annotations

import codecs
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from io import BytesIO

import torch

from werkzeug.serving import run_simple
from werkzeug.wrappers import Request, Response

from moephoto_tpu_torch.config import VERSION, referenceRoot, setConfig
from moephoto_tpu_torch.runtime.preset import handlePreset, initPreset
from moephoto_tpu_torch.utils.fifocache import Cache

config: dict = {}
try:
    setConfig(config, VERSION)
    initPreset(config)
    dVer = {"version": config.get("version", VERSION)}
except Exception as e:  # pragma: no cover - a broken user config or manifest: defaults
    logging.warning(e)
    dVer = {"version": VERSION}

staticMaxAge = 86400
startupTime = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
E403 = ("Not authorized.", 403)
E404 = ("Not Found", 404)
OK = ("", 200)


class Current:
    session = None
    path = None
    key = None
    eta = 0
    setETA = True
    fileSize = 0
    stopFlag = None
    getPreview = None
    writeFile = None
    poller = None  # the thread that reads the notes pipe for the session


current = Current()
cache = Cache(config.get("maxResultsKept", 1 << 10), OK, lambda *a: logging.info("abandoned"))
busy = lambda: (json.dumps(dict(result="Busy", eta=current.eta)), 503)
cwd = os.getcwd()
outDir = config.get("outDir", "download")
uploadDir = config.get("uploadDir", "upload")
logPath = os.path.abspath(config.get("logPath", ".user/log.txt"))
previewFormat = config.get("videoPreview", "jpeg")
noteEvent = threading.Event()
toResponse = lambda obj, code=200: obj if isinstance(obj, tuple) else (
    json.dumps(obj, ensure_ascii=False, separators=(",", ":")), code
)

_routes = {}


def route(path, methods=("GET", "POST")):
    def deco(f):
        _routes[path] = (f, set(methods))
        return f

    return deco


def tryFunc(f, *args):
    try:
        return f(*args)
    except Exception:
        return None


def updateETA(res):
    if "eta" in res:
        current.eta = res["eta"]


def updateNote(key, note):
    if note and len(note):
        if current.setETA:
            updateETA(note)
        else:
            note.pop("total", 0)
            note.pop("gone", 0)
            note.pop("eta", 0)
        if "fileSize" in note:
            current.fileSize = note["fileSize"]
            del note["fileSize"]
        if len(note):
            cache.update(key, note)
            noteEvent.set()


def pollNote():
    key = current.key
    while current.key:
        if noter.poll(0.05):
            while noter.poll():
                updateNote(key, noter.recv())
        else:
            time.sleep(0.01)


def stopPolling():
    """End the session's note reader and wait for it, so that the notes
    pipe never has two readers: reads from two threads at once tear the
    pipe's messages apart."""
    current.key = None
    if current.poller is not None:
        current.poller.join()
        current.poller = None


sessionLock = threading.Lock()


def acquireSession(req: Request):
    # the server is threaded: the busy check-then-set must be atomic or
    # two concurrent enhance POSTs interleave on the single worker pipe
    with sessionLock:
        if current.session:
            return busy()
        current.session = -1
    stopPolling()  # a session refused below (E403) never reached endSession
    current.eta = 0.1
    while noter.poll():
        noter.recv()
    values = req.values
    current.session = values.get("session")
    current.path = values.get("path", req.path)
    current.key = (current.path or "") + str(current.session)
    cache.put(current.key, {"eta": 60})
    current.poller = threading.Thread(target=pollNote, name="pollNote", daemon=True)
    current.poller.start()
    current.eta = 1
    updateETA(values)
    return False if current.session else E403


def stopCurrent(*_):
    if current.session:
        current.stopFlag.set()
    return OK


def checkMsgMatch(req):
    path = req.values.get("path")
    return path is None or path == current.path


def onConnect(key):
    while not (current.session is None or (key and cache.peek(key))):
        noteEvent.clear()
        noteEvent.wait(0.2)
    if key and cache.peek(key):
        return toResponse(cache.pop(key))
    return OK


def endSession(result):
    cache.put(current.key, result)
    stopPolling()
    current.session = None
    return toResponse(result)


getKey = lambda session, req: (
    req.values["path"] + str(session) if "path" in req.values else current.key
)


def controlPoint(path, fMatch, fUnmatch, fNoCurrent, check=lambda *_: True):
    def f(req):
        session = req.values.get("session")
        if not session:
            return E403
        key = getKey(session, req)
        if current.session:
            return fMatch(key) if current.session == session and check(req) else fUnmatch()
        return fNoCurrent(key)

    _routes[path] = (f, {"GET", "POST"})


def makeHandler(name, prepare, final, methods=("POST",)):
    def f(req):
        c = acquireSession(req)
        if c:
            return c
        try:
            args = prepare(req)
        except Exception as e:
            res = (str(e), 400)
            endSession(res)
            return res
        sender.send((name, *args))
        return endSession(final(receiver.recv(), req))

    _routes["/" + name] = (f, set(methods))


readOpt = lambda req: json.loads(req.values["steps"])


def clientFileName(fp):
    """The file name a client sent, without any directory part, so that no
    upload or output lands outside its directory; raises on a name that
    leaves nothing (the reference takes the name as given)."""
    name = os.path.basename((fp.filename or "").replace("\\", "/"))
    if name in ("", ".", "..") or "\0" in name:
        raise ValueError("Bad file name: {!r}".format(fp.filename))
    return name


def outputSteps(req):
    """The client's steps; the output file they may name (the frontend
    sends ``download/<name>``) must lie under ``outDir``."""
    steps = readOpt(req)
    if steps and "file" in steps[-1] and not safeJoin(os.path.join(cwd, outDir), os.path.join(cwd, steps[-1]["file"])):
        raise ValueError("Output outside {}: {!r}".format(outDir, steps[-1]["file"]))
    return steps


def setOutputName(args, fp):
    if not len(args):
        args = ({"op": "output"},)
    if "file" in args[-1]:
        return args
    base, ext = os.path.splitext(clientFileName(fp))
    path = "{}/{}{}".format(outDir, base, ext)
    i = 0
    while os.path.exists(path):
        i += 1
        path = "{}/{}_{}{}".format(outDir, base, i, ext)
    args[-1]["file"] = path
    return args


def responseEnhance(t, req):
    res, code = t
    if "eta" in req.values:
        res["eta"] = float(req.values["eta"])
    res.update((k, int(req.values[k])) for k in ("gone", "total") if k in req.values)
    return toResponse(res, code)


# --- pages -----------------------------------------------------------------

_templateDir = None
_staticDir = None
_jinjaEnv = None


def findFrontend():
    """Locate the templates/static dirs under the working directory; an
    external checkout is consulted only when explicitly configured
    (``referenceRoot`` / MOEPHOTO_REFERENCE_ROOT, a dev flag)."""
    global _templateDir, _staticDir
    roots = ["."]
    if referenceRoot():
        roots.append(referenceRoot())
    for root in roots:
        t = os.path.join(root, "templates")
        if _templateDir is None and os.path.isdir(t):
            _templateDir = t
        s = os.path.join(root, "static")
        if _staticDir is None and os.path.isdir(s):
            _staticDir = s
    return _templateDir, _staticDir


def renderPage(template, **context):
    global _jinjaEnv
    tDir, _ = findFrontend()
    if tDir is None:
        return "<html><body>MoePhoto-TPU</body></html>"
    if _jinjaEnv is None:
        import jinja2

        _jinjaEnv = jinja2.Environment(loader=jinja2.FileSystemLoader(tDir))
    return _jinjaEnv.get_template(template).render(**context)


ndoc = (
    '<a href="{dirName}/{image}" class="w3effct-agile"><img src="{dirName}/{image}"'
    ' alt="" class="img-responsive" title="Solar Panels Image" />'
    '<div class="agile-figcap"><h4>相册</h4><p>图片{image}</p></div></a>'
)


def gallery(req):
    """Downloads gallery page body."""
    dirName = req.values.get("dir", outDir)
    items = tryFunc(os.listdir, dirName) or []
    images = [
        i for i in items
        if i.split(".")[-1] in {"png", "jpg", "jpeg", "webp", "bmp", "gif"}
    ]
    doc = []
    tags = [ndoc.format(image=image, dirName=dirName) for image in images]
    for i in range((len(tags) - 1) // 3 + 1):
        doc.append('<div class="col-sm-4 col-xs-4 w3gallery-grids">')
        doc.extend(tags[i * 3 : (i + 1) * 3])
        doc.append("</div>")
    return ("".join(doc) if doc else "暂时没有图片，快去尝试放大吧",)


def cardNames():
    """``cuda:<index> <name>`` of every card, from nvidia-smi (asking
    torch would create a CUDA context in this process)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,name", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=30).stdout
    return ["cuda:{} {}".format(*(f.strip() for f in ln.split(",", 1))) for ln in out.splitlines() if ln.strip()]


def getSystemInfo(info):
    """The system page's static fields.  ``templates/system.html`` prints
    ``{{ jax }}``; the port reports ``torch`` instead, so that field stays
    empty."""
    import psutil

    info = dict(info)
    info.update(
        {
            "cpu_count_phy": tryFunc(lambda: psutil.cpu_count(logical=False)),
            "cpu_count_log": tryFunc(lambda: psutil.cpu_count(logical=True)),
            "cpu_freq": tryFunc(lambda: psutil.cpu_freq().max),
            "disk_total": tryFunc(lambda: psutil.disk_usage(cwd).total // 2**20),
            "mem_total": tryFunc(lambda: psutil.virtual_memory().total // 2**20),
            "python": sys.version,
            "torch": torch.__version__,
            "devices": tryFunc(cardNames),
        }
    )
    return info


def getDynamicInfo(_):
    import psutil

    disk_free = tryFunc(lambda: psutil.disk_usage(cwd).total // 2**20)
    mem_free = tryFunc(lambda: psutil.virtual_memory().total // 2**20)
    return disk_free, mem_free, current.session, current.path


def buildPages():
    tDir, _ = findFrontend()
    if tDir is None:
        return
    headerPath = os.path.join(tDir, "1-header.html")
    header = codecs.open(headerPath, "r", "utf-8").read() if os.path.exists(headerPath) else ""
    footerPath = os.path.join(tDir, "1-footer.html")
    footer = codecs.open(footerPath, "r", "utf-8").read() if os.path.exists(footerPath) else ""
    pages = [
        ("/", "index.html", "主页", None, None, dVer),
        ("/video", "video.html", "AI视频", None, None, dVer),
        ("/batch", "batch.html", "批量放大", None, None, dVer),
        ("/document", "document.html", None, None, None, dVer),
        ("/about", "about.html", None,
         lambda *_: [tryFunc(lambda: codecs.open("./update_log.txt", encoding="utf-8").read()) or ""],
         ["log"], dVer),
        ("/system", "system.html", None, getDynamicInfo,
         ["disk_free", "mem_free", "session", "path"], getSystemInfo(dVer)),
        ("/lock", "lock.html", None, None, None, dVer),
        ("/gallery", "gallery.html", None, gallery, ["var"], dVer),
    ]
    for pathRoute, template, active, func, names, other in pages:
        h = re.sub(">" + active, 'class="active">' + active, header) if active else header

        def make(template=template, func=func, names=names, other=other, h=h):
            def f(req):
                ctx = dict(other)
                if func:
                    ctx.update(dict(zip(names, func(req))))
                try:
                    body = renderPage(template, header=h, footer=footer, **ctx)
                except Exception as e:  # a broken template still answers
                    body = f"<html><body>{template}: {e}</body></html>"
                return Response(body, mimetype="text/html")

            return f

        _routes[pathRoute] = (make(), {"GET"})


# --- task endpoints --------------------------------------------------------


def registerHandlers():
    controlPoint("/stop", stopCurrent, lambda: E403, lambda *_: E404)
    controlPoint("/msg", onConnect, busy, lambda key: cache.pop(key), checkMsgMatch)

    lockFinal = lambda result, *_: (
        (json.dumps(dict(result="Interrupted", remain=result)), 200)
        if isinstance(result, (int, float)) and result > 0
        else (json.dumps(dict(result="Idle")), 200)
    )
    makeHandler(
        "lockInterface",
        lambda req: [int(float(readOpt(req)[0]["duration"]))],
        lockFinal,
        ("GET", "POST"),
    )
    makeHandler("systemInfo", lambda _: [], lambda x, *_: x, ("GET", "POST"))

    def imageEnhancePrep(req):
        fp = req.files["file"]
        return (current.writeFile(fp), *setOutputName(outputSteps(req), fp))

    makeHandler("image_enhance", imageEnhancePrep, responseEnhance)

    def videoEnhancePrep(req):
        os.makedirs(uploadDir, exist_ok=True)
        for k in ("url", "cmd"):
            v = req.values.get(k)
            if v:
                return (v, k, *outputSteps(req))
        vidfile = req.files["file"]
        path = "{}/{}".format(uploadDir, clientFileName(vidfile))
        vidfile.save(path)
        return (path, False, *setOutputName(outputSteps(req), vidfile))

    makeHandler("video_enhance", videoEnhancePrep, responseEnhance)

    def batchEnhance(req):
        c = acquireSession(req)
        if c:
            return c
        current.stopFlag.clear()
        count = fail = 0
        fails, done = [], []
        result = "Success"
        fileList = req.files.getlist("file")
        try:
            names = [clientFileName(image) for image in fileList]
        except ValueError as e:
            return endSession((str(e), 400))
        output_path = "{}/{}/".format(outDir, int(time.time()))
        os.makedirs(output_path, exist_ok=True)
        opt = readOpt(req)
        total = len(fileList)
        opt.append(dict(trace=False, op="output"))
        current.setETA = False
        for image, name in zip(fileList, names):
            if current.stopFlag.is_set():
                result = "Interrupted"
                break
            name = os.path.join(output_path, name)
            start = time.time()
            opt[-1]["file"] = name
            current.fileSize = current.writeFile(image)
            sender.send(("batch", current.fileSize, *opt))
            output = receiver.recv()
            count += 1
            note = {
                "eta": (total - count) * (time.time() - start),
                "gone": count,
                "total": total,
            }
            updateETA(note)
            if output[1] == 200:
                note["preview"] = name
                done.append(name)
            else:
                fail += 1
                fails.append(name)
            cache.put(current.key, note)
        current.setETA = True
        return endSession({"result": (result, count, done, fail, fails, output_path)})

    _routes["/batch_enhance"] = (batchEnhance, {"POST"})
    _routes["/preset"] = (lambda req: handlePreset(req.values), {"GET", "POST"})
    _routes["/log"] = (
        lambda req: Response(
            open(logPath, "rb").read() if os.path.exists(logPath) else b"",
            mimetype="text/plain",
        ),
        {"GET"},
    )
    _routes["/{}/.preview.{}".format(outDir, previewFormat)] = (
        lambda req: Response(current.getPreview().read(), mimetype="image/" + previewFormat),
        {"GET"},
    )


def safeJoin(root, rel):
    """Join ``rel`` under ``root`` and refuse any escape ('..', absolute
    paths, symlink tricks) by realpath containment — the analog of
    flask's traversal-safe send_from_directory."""
    root = os.path.realpath(root)
    c = os.path.realpath(os.path.join(root, rel))
    if c == root or c.startswith(root + os.sep):
        return c
    return None


def serveStatic(req, path):
    _, sDir = findFrontend()
    candidates = []
    if path.startswith(outDir + "/"):
        candidates.append(safeJoin(os.path.join(cwd, outDir), path.split("/", 1)[-1]))
    if sDir:
        # never join against dirname(sDir): with the in-repo frontend that
        # is the repo root, and containment there would let
        # /download/../<anything-in-repo> through
        candidates.append(safeJoin(sDir, path.split("/", 1)[-1]))
    for c in candidates:
        if c and os.path.isfile(c):
            import mimetypes

            mt = mimetypes.guess_type(c)[0] or "application/octet-stream"
            return Response(open(c, "rb").read(), mimetype=mt)
    return Response("Not Found", status=404)


@Request.application
def app(req: Request):
    path = req.path
    entry = _routes.get(path)
    if entry is not None:
        f, methods = entry
        if req.method not in methods:
            return Response("Method Not Allowed", status=405)
        res = f(req)
        if isinstance(res, Response):
            resp = res
        else:
            body, code = toResponse(res) if not isinstance(res, tuple) else res
            if isinstance(body, (dict, list)):  # flask-style auto-JSON
                body = json.dumps(body, ensure_ascii=False, separators=(",", ":"))
            resp = Response(body, status=code, mimetype="application/json")
        session = req.cookies.get("session")
        t = time.time()
        if (not session) or tryFunc(lambda: float(session) > t):
            resp.set_cookie("session", str(t))
        return resp
    if path.startswith("/" + outDir + "/") or path.startswith("/static/"):
        return serveStatic(req, path.lstrip("/"))
    if path == "/favicon.ico":
        roots = ["."] + ([referenceRoot()] if referenceRoot() else [])
        for root in roots:
            p = os.path.join(root, "logo3.ico")
            if os.path.exists(p):
                return Response(open(p, "rb").read(), mimetype="image/x-icon")
    return Response("Not Found", status=404)


def runserver(taskInSender, taskOutReceiver, noteReceiver, stopEvent, mm, isWindows):
    global sender, receiver, noter
    sender = taskInSender
    receiver = taskOutReceiver
    noter = noteReceiver
    current.stopFlag = stopEvent
    mmView = memoryview(mm) if isWindows else mm.buf
    current.getPreview = lambda: BytesIO(bytes(mmView[: current.fileSize]))
    if not isWindows:
        mm = mm.buf.obj

    def writeFile(file):
        mm.seek(0)
        stream = getattr(file, "stream", None) or getattr(file, "_file", file)
        data = stream.read()
        mm.write(data)
        return len(data)

    current.writeFile = writeFile
    os.makedirs(outDir, exist_ok=True)
    buildPages()
    registerHandlers()

    def f(host, port):
        logging.info("Server listening on http://%s:%s/", host, port)
        run_simple(host, port, app, threaded=True)

    return f
