"""Self-update from a release manifest and a ranged multithreaded
download: fetches a version manifest, downloads changed files (ranged,
parallel chunks), and can fetch an ffmpeg build for the video engine.
Nothing in the app calls it yet.

Network access is fully optional — every function degrades to a no-op
result when the endpoint is unreachable.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request
import zipfile
from typing import List, Optional

from moephoto_tpu_torch.config import VERSION, compareVersion

log = logging.getLogger("Moe")
CHUNK = 1 << 20


def fetch(url: str, timeout: int = 10) -> Optional[bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    except Exception as e:
        log.warning("fetch %s failed: %s", url, e)
        return None


def downloadRanged(url: str, dest: str, threads: int = 4) -> bool:
    """Ranged parallel download in ``threads`` chunks."""
    try:
        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=10) as r:
            size = int(r.headers.get("Content-Length", 0))
            ranged = r.headers.get("Accept-Ranges") == "bytes"
    except Exception as e:
        log.warning("HEAD %s failed: %s", url, e)
        return False
    if not size or not ranged or threads <= 1:
        data = fetch(url, timeout=300)
        if data is None:
            return False
        with open(dest, "wb") as fp:
            fp.write(data)
        return True
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "wb") as fp:
        fp.truncate(size)
    chunk = (size + threads - 1) // threads
    errs: List = []

    def worker(lo, hi):
        try:
            req = urllib.request.Request(url, headers={"Range": f"bytes={lo}-{hi - 1}"})
            with urllib.request.urlopen(req, timeout=300) as r:
                with open(dest, "r+b") as fp:
                    fp.seek(lo)
                    while True:
                        buf = r.read(CHUNK)
                        if not buf:
                            break
                        fp.write(buf)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [
        threading.Thread(target=worker, args=(i * chunk, min(size, (i + 1) * chunk)))
        for i in range(threads)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        log.warning("ranged download errors: %s", errs[:1])
        return False
    return True


def checkUpdate(manifestUrl: str) -> Optional[dict]:
    """Fetch the release manifest; returns it if newer than VERSION."""
    data = fetch(manifestUrl)
    if data is None:
        return None
    try:
        manifest = json.loads(data)
    except Exception:
        return None
    if compareVersion(manifest.get("version", "0"), VERSION) > 0:
        return manifest
    return None


def update(manifestUrl: str, targetDir: str = ".") -> bool:
    manifest = checkUpdate(manifestUrl)
    if not manifest:
        return False
    ok = True
    for item in manifest.get("files", []):
        dest = os.path.join(targetDir, item["path"])
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        ok &= downloadRanged(item["url"], dest)
    return ok


def updateFfmpeg(url: str, destDir: str = "ffmpeg") -> bool:
    """Download and unpack an ffmpeg build."""
    tmp = os.path.join(destDir, "_ffmpeg.zip")
    os.makedirs(destDir, exist_ok=True)
    if not downloadRanged(url, tmp):
        return False
    try:
        with zipfile.ZipFile(tmp) as z:
            z.extractall(destDir)
        os.remove(tmp)
        return True
    except Exception as e:  # pragma: no cover
        log.warning("ffmpeg unpack failed: %s", e)
        return False
