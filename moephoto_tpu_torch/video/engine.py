"""Video pipeline orchestration over ffmpeg raw-frame pipes, as in the
JAX package (``moephoto_tpu/video/engine.py``).

Protocol (shared with the reference so presets and clients behave the
same): decode to raw ``bgr48le`` (6 B/px) on stdout, stream frames
through the compiled step pipeline, feed output frames to an encoder's
stdin; audio is either muxed straight from the source file (uploads),
extracted and merged afterwards (URL/cmd sources), or dropped for
video-only streams.  Reference-frame accounting for segment resume
(lookback/lookahead per temporal step) follows ``video.py:146-264``.

ffmpeg commands are assembled by explicit builders keyed on the audio
strategy; a fake-ffmpeg harness (tools/fakeffmpeg.py) drives the tests.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import subprocess as sp
import sys
import threading
from math import ceil
from queue import Empty, Queue

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.pipeline.steps import genProcess
from moephoto_tpu_torch.progress import Node, initialETA
from moephoto_tpu_torch.runtime.context import context
from moephoto_tpu_torch.runtime.worker import begin

log = logging.getLogger("Moe")

PIX_FMT = "bgr48le"
BYTES_PER_PIXEL = 6
PIPE_BUFSIZE = 10**8
VIDEO_EXTS = {".mp4", ".ts", ".mkv"}

stepVideo = [dict(op="buffer", bitDepth=16)]
qOut: Queue = Queue(256)

_reStreamInfo = re.compile(r"Stream #.*: Video:")
_reGeometry = re.compile(r",[\s]*([\d]+)x([\d]+)[\s]*.+,[\s]*([.\d]+)[\s]*(fps|tbr)")
_reFrameLine = re.compile(r"frame=")
_reFrameCount = re.compile(r"frame=[\s]*([\d]+) ")
_reAudioStream = re.compile(r"Stream #0:1")
_reOutputBanner = re.compile(r"Output #0,")

resizeOp = {"SR", "resize", "VSR"}
padOp = {"VSR", "demob"}


def _temporalWindow(op: str):
    """(lookback, lookahead) reference frames per temporal op
    (video.py:37-38): ``slomo``, ``VSR`` and ``demob``."""
    if op == "slomo":
        from moephoto_tpu_torch.models.ifrnet import RefTime

        return RefTime >> 1, (RefTime - 1) >> 1
    if op == "VSR":
        from moephoto_tpu_torch.models.iconvsr import RefTime

        return RefTime >> 1, (RefTime - 1) >> 1
    from moephoto_tpu_torch.models.estrnn import futureFrames, pastFrames

    return pastFrames, futureFrames


lookbackOf = lambda op: _temporalWindow(op)[0]
lookaheadOf = lambda op: _temporalWindow(op)[1]


def removeFile(path):
    """Delete a consumed upload, but only from the upload directory.

    The reference unlinks the input unconditionally after processing
    (video.py), which deletes user-owned files whenever a caller passes a
    direct path with ``by=''``: anything outside ``config.uploadDir`` is
    the caller's property and is left alone."""
    up = os.path.abspath(getattr(config, "uploadDir", "upload"))
    if os.path.commonpath([up, os.path.abspath(path)]) != up:
        log.info("Not removing non-upload input %s", path)
        return
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
    except PermissionError as e:
        log.error(str(e))


def _withExt(path: str) -> str:
    base, ext = os.path.splitext(path)
    return path if ext in VIDEO_EXTS else base + ".mkv"


def _suffixed(path: str, tag: str) -> str:
    base, ext = os.path.splitext(path)
    return base + tag + ext


# --------------------------------------------------------------------------
# ffmpeg commands
# --------------------------------------------------------------------------


def _inputArgs(video: str, by) -> list:
    """-i arguments; lavfi demuxer for synthetic/cmd sources."""
    return (["-f", "lavfi"] if by == "cmd" else []) + ["-i", video]


def buildProbeCommand(video: str, by, countFrames: bool) -> list:
    cmd = [config.ffmpegPath, "-hide_banner"]
    if not countFrames:
        cmd += ["-t", "1"]
    cmd += _inputArgs(video, by)
    cmd += ["-map", "0:v:0", "-c", "copy", "-f", "null", "-"]
    return cmd


def buildDecodeCommand(video: str, by, decodec: str, audioPath) -> list:
    cmd = [config.ffmpegPath, "-hide_banner"]
    cmd += _inputArgs(video, by)
    if audioPath:  # split non-video tracks for a later merge
        cmd += ["-vn", "-c", "copy", "-y", audioPath]
    cmd += [
        "-sws_flags", "spline+accurate_rnd+full_chroma_int",
        "-color_trc", "2", "-colorspace", "2", "-color_primaries", "2",
        "-map", "0:v", "-f", "rawvideo", "-pix_fmt", PIX_FMT,
    ]
    if decodec:
        cmd += decodec.split(" ")
    cmd.append("-")
    return cmd


def buildEncodeCommand(
    geometry: str, fps, encodec: str, target: str, audioFrom=None
) -> list:
    """Encoder reading raw frames on stdin; ``audioFrom`` optionally muxes
    the non-video tracks of another file in the same pass."""
    meta = ["-metadata", 'service_provider="MoePhoto-TPU {}"'.format(config.version)]
    cmd = [
        config.ffmpegPath, "-hide_banner", "-y",
        "-f", "rawvideo", "-pix_fmt", PIX_FMT,
        "-s", geometry, "-r", str(fps),
        "-thread_queue_size", "64", "-i", "-",
    ]
    if audioFrom:
        cmd += ["-i", audioFrom, "-map", "0:v", "-map", "1?", "-map", "-1:v",
                "-c:1", "copy"]
    cmd += meta + ["-c:v:0"] + encodec.split(" ") + [target]
    return cmd


def buildMergeCommand(videoPath: str, audioPath: str, target: str) -> list:
    meta = ["-metadata", 'service_provider="MoePhoto-TPU {}"'.format(config.version)]
    return [
        config.ffmpegPath, "-hide_banner", "-y",
        "-i", videoPath, "-i", audioPath,
        "-map", "0:v", "-map", "1?", "-c:0", "copy", "-c:1", "copy",
        *meta, target,
    ]


# --------------------------------------------------------------------------
# probing / subprocess plumbing
# --------------------------------------------------------------------------


def getVideoInfo(videoPath, by, width, height, frameRate):
    """Parse geometry/fps/frame-count/audio from ffmpeg stderr."""
    needInfo = not (width and height and frameRate)
    needFrames = not by
    cmd = buildProbeCommand(videoPath, by, needFrames)
    proc = sp.Popen(cmd, stderr=sp.PIPE, encoding="utf_8", errors="ignore")
    totalFrames = 0
    videoOnly = True
    sawOutput = False
    try:
        while True:
            line = proc.stderr.readline()
            if not line:
                break
            line = line.lstrip()
            if _reOutputBanner.match(line):
                sawOutput = True
            elif _reAudioStream.match(line):
                videoOnly = False
            if needInfo and _reStreamInfo.match(line):
                m = _reGeometry.search(line)
                if not m:
                    log.error(line)
                    raise RuntimeError("Video info not found")
                width = width or int(m.group(1))
                height = height or int(m.group(2))
                frameRate = frameRate or float(m.group(3))
                needInfo = False
            if needFrames and _reFrameLine.match(line):
                m = _reFrameCount.search(line)
                if m:
                    totalFrames = int(m.group(1))
            if not needInfo and sawOutput and (totalFrames or not needFrames):
                # keep draining briefly; loop exits on EOF
                pass
        proc.stderr.close()
    finally:
        proc.terminate()
    if needInfo or (not by and not totalFrames):
        raise RuntimeError("Video info not found")
    log.info("Video %s: %dx%d@%s, %d frames", videoPath, width, height, frameRate, totalFrames)
    return width, height, frameRate, totalFrames, videoOnly


def _drainThread(pipe):
    def pump():
        try:
            for line in iter(pipe.readline, b""):
                qOut.put(line)
            pipe.flush()
        except Exception:
            qOut.put("ffmpeg pipe exception")

    t = threading.Thread(target=pump, daemon=True)
    t.start()


def _echoDrained():
    while True:
        try:
            line = qOut.get_nowait()
        except Empty:
            break
        if not isinstance(line, str):
            line = str(line, encoding="utf_8", errors="replace")
        sys.stdout.write(line)


# --------------------------------------------------------------------------
# step-chain preparation (reference video.py:146-264 semantics)
# --------------------------------------------------------------------------


def prepare(video, by, steps):
    optEncode = steps[-1]
    optDecode = steps[0]
    optRange = steps[1]
    encodec = optEncode.get("codec", config.defaultEncodec)
    decodec = optDecode.get("codec", config.defaultDecodec)
    start = max(0, int(optRange.get("start", 0)))
    procSteps = stepVideo + list(steps[2:-1])
    diagnose = optEncode.get("diagnose", {})
    process, nodes = genProcess(procSteps)
    root = begin(
        Node({"op": "video"}, 1, 2, 0),
        nodes,
        config.progressDetail or diagnose.get("bench", False),
        diagnose.get("bench", False),
        diagnose.get("clear", False),
    )
    context.root = root

    # reference-frame bookkeeping for mid-video starts and stream tails
    cumStart = start
    for step in procSteps:
        if step["op"] == "slomo":
            step["opt"].start = cumStart
            cumStart *= step["sf"]
    refs, ahead = 0, 0
    for step in reversed(procSteps):
        if step["op"] == "slomo":
            step["opt"].outStart = -refs % step["sf"] if refs else 1
            step["opt"].outEnd = -(-ahead % step["sf"])
            refs = max(ceil(refs / step["sf"]), lookbackOf("slomo"))
            ahead = max(ceil(ahead / step["sf"]), lookaheadOf("slomo"))
        elif step["op"] in padOp:
            step["opt"].start = 0
            step["opt"].end = 0
            refs += lookbackOf(step["op"])
            ahead += lookaheadOf(step["op"])
    if start < refs:  # not enough decoded frames to serve as references
        arefs = start
        for step in procSteps:
            if arefs >= refs:
                break
            if step["op"] == "slomo":
                refs = refs * step["sf"] - step["opt"].outStart
                step["opt"].outStart = 0
                arefs = arefs * step["sf"]
            elif step["op"] in padOp:
                step["opt"].start = min(refs - arefs, lookbackOf(step["op"]))
                refs -= step["opt"].start
        start = 0
    else:
        start -= refs

    stop = int(optRange.get("stop", -1))
    if stop <= start:
        stop = -1
    root.total = -1 if stop < 0 else stop - start

    outputPath = _withExt(optEncode.get("file", "") or config.outDir + "/" + config.getPath())
    slomos = [s for s in procSteps if s["op"] == "slomo"]
    sizes = [s for s in procSteps if s["op"] in resizeOp]
    return dict(
        outputPath=outputPath,
        process=process,
        start=start,
        stop=stop,
        refs=ahead,
        root=root,
        by=by,
        video=video,
        decodec=decodec,
        encodec=encodec,
        slomos=slomos,
        sizes=sizes,
        width=optDecode.get("width", 0),
        height=optDecode.get("height", 0),
        frameRate=optEncode.get("frameRate", 0),
    )


def planCommands(p, width, height, frameRate, totalFrames, videoOnly):
    """Output geometry + the three command lines, per the audio strategy."""
    root = p["root"]
    if root.total < 0 and totalFrames > 0:
        root.total = totalFrames - p["start"]
    if frameRate:
        for opt in p["slomos"]:
            frameRate *= opt["sf"]
    outW, outH = width, height
    for opt in p["sizes"]:
        if opt["op"] == "SR":
            outW *= opt["scale"]
            outH *= opt["scale"]
        elif opt["op"] == "VSR":
            outW *= 4
            outH *= 4
        else:
            outW = round(outW * opt["scaleW"]) if "scaleW" in opt else opt["width"]
            outH = round(outH * opt["scaleH"]) if "scaleH" in opt else opt["height"]
    geometry = f"{outW}x{outH}"
    videoOnly |= p["start"] > 0
    outputPath = p["outputPath"]
    audioPath = _suffixed(outputPath, "-a")

    mergeCmd = None
    if videoOnly:
        # no other tracks: decode video only, encode straight to target
        decodeCmd = buildDecodeCommand(p["video"], p["by"], p["decodec"], None)
        encodeCmd = buildEncodeCommand(geometry, frameRate, p["encodec"], outputPath)
    elif p["by"]:
        # URL/cmd source: split audio now, merge after encoding
        decodeCmd = buildDecodeCommand(p["video"], p["by"], p["decodec"], audioPath)
        tempVideo = _suffixed(outputPath, "-v")
        encodeCmd = buildEncodeCommand(geometry, frameRate, p["encodec"], tempVideo)
        mergeCmd = buildMergeCommand(tempVideo, audioPath, outputPath)
    else:
        # uploaded file: mux audio straight from the source in one pass
        decodeCmd = buildDecodeCommand(p["video"], p["by"], p["decodec"], None)
        encodeCmd = buildEncodeCommand(
            geometry, frameRate, p["encodec"], outputPath, audioFrom=p["video"]
        )
    root.multipleLoad(width * height * 3)
    initialETA(root)
    root.reset().trace(0)
    return decodeCmd, encodeCmd, mergeCmd


def _mergeTracks(mergeCmd):
    if not mergeCmd:
        return 0, 0
    proc = sp.Popen(mergeCmd, stderr=sp.PIPE, encoding="utf_8", errors="ignore")
    _drainThread(proc.stderr)
    err, msg = proc.communicate()
    sys.stdout.write(msg or "")
    return proc, err


def _removeIntermediate(path):
    """Delete an engine-created scratch file (merge intermediates carry
    derived ``-v``/``-a`` names next to the output, not in the upload
    dir, so the `removeFile` upload containment guard would refuse)."""
    try:
        os.remove(path)
    except OSError:
        pass


def _cleanupMerge(mergeCmd, outputPath):
    """Remove intermediates after a merge (temp video + audio)."""
    if not mergeCmd:
        return outputPath
    tempVideo, audioPath = mergeCmd[4], mergeCmd[6]
    merged = os.path.exists(outputPath)
    _removeIntermediate(audioPath)
    if merged:
        _removeIntermediate(tempVideo)
        return outputPath
    return tempVideo


# --------------------------------------------------------------------------
# main loop
# --------------------------------------------------------------------------


def SR_vid(video, by, *steps):
    context.stopFlag.clear()
    p = prepare(video, by, steps)
    process, start, stop, refs, root = (
        p["process"], p["start"], p["stop"], p["refs"], p["root"],
    )
    root.callback(root, dict(eta=100000))
    width, height, *info = getVideoInfo(video, by, p["width"], p["height"], p["frameRate"])
    root.callback(root, dict(shape=[height, width], fps=info[0], eta=60000))
    decodeCmd, encodeCmd, mergeCmd = planCommands(p, width, height, *info)

    procIn = sp.Popen(decodeCmd, stdout=sp.PIPE, stderr=sp.PIPE, bufsize=PIPE_BUFSIZE)
    procOut = sp.Popen(encodeCmd, stdin=sp.PIPE, stdout=sp.PIPE, stderr=sp.PIPE, bufsize=0)
    procMerge = 0
    mergeErr = 0
    i = 0
    raw = b""
    outputPath = p["outputPath"]

    def push(rawFrame=None):
        bufs = process((rawFrame, height, width))
        if bufs:
            for buffer in bufs:
                if buffer:
                    procOut.stdin.write(buffer)
        return 0 if bufs is None else len(bufs)

    try:
        _drainThread(procOut.stdout)
        _drainThread(procIn.stderr)
        _drainThread(procOut.stderr)
        frameBytes = width * height * BYTES_PER_PIXEL

        # double-buffered ingest: a reader thread prefetches the next
        # raw frame (blocking pipe read) while the main thread queues
        # device work for the current one
        import queue as _queue

        frameQ: "_queue.Queue" = _queue.Queue(maxsize=2)
        readerStop = threading.Event()

        def _reader():
            # decoder-pipe I/O errors travel through the queue as the
            # exception object (re-raised by the main loop), not as a
            # clean end of stream; bounded puts poll readerStop so an
            # aborted task cannot leave this thread blocked
            while not readerStop.is_set():
                try:
                    b = procIn.stdout.read(frameBytes)
                except Exception as e:  # noqa: BLE001 - forwarded
                    b = e
                while not readerStop.is_set():
                    try:
                        frameQ.put(b, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if not isinstance(b, (bytes, bytearray)) or len(b) == 0:
                    break

        threading.Thread(target=_reader, daemon=True).start()
        while (stop < 0 or i <= stop + refs) and not context.stopFlag.is_set():
            raw = frameQ.get()
            if isinstance(raw, Exception):
                raise raw
            if len(raw) == 0:
                break
            _echoDrained()
            if i >= start:
                push(raw)
            elif (i + 1) % 10 == 0:
                root.callback(root, dict(skip=i + 1))
            i += 1
        os.kill(procIn.pid, signal.SIGINT)
        if len(raw) == 0:  # stream ended: tell temporal steps to pad tails
            arefs = 0 if stop <= 0 or i < stop else i - stop
            for step in steps:
                if arefs >= refs:
                    break
                if step["op"] == "slomo":
                    refs = refs * step["sf"] + step["opt"].outEnd
                    step["opt"].outEnd = 0
                    arefs = arefs * step["sf"]
                elif step["op"] in padOp:
                    step["opt"].end = -min(refs - arefs, lookaheadOf(step["op"]))
                    refs += step["opt"].end
        push()
        procOut.communicate(timeout=300)
        procIn.terminate()
        _echoDrained()
        procMerge, mergeErr = _mergeTracks(mergeCmd)
    finally:
        log.info("Video processing end at frame #%d.", i - refs)
        try:
            readerStop.set()
        except NameError:
            pass  # failed before ingest setup
        procIn.terminate()
        procOut.terminate()
        if procMerge:
            procMerge.terminate()
        try:
            if not by:
                removeFile(video)
        except Exception:
            log.warning("Could not remove %s.", video)
        if mergeErr:
            log.warning("Track merge failed: %s.", mergeErr)
        else:
            outputPath = _cleanupMerge(mergeCmd, outputPath)
    _echoDrained()
    return outputPath, i - refs
