"""Named step-chain presets stored as JSON under ``.user/preset_*``.

Serves the frontend's preset picker: listing returns briefs
``{name, notes}``, fetching returns the raw JSON text, saving writes
``<name>.json``.  Files are re-read only when their mtime advances, and
presets written by a newer app version are rejected ("Incompatible
version").  HTTP semantics: an unknown type or any error gives 403, a
missing preset 404.
"""

from __future__ import annotations

import json
import os
import time

from moephoto_tpu_torch.config import VERSION, compareVersion

version = VERSION
PRESET_TYPES = ("image", "video")
COMPACT = dict(ensure_ascii=False, separators=(",", ":"))

getBrief = lambda item: dict(name=item["name"], notes=item.get("notes", []))


class PresetStore:
    """One preset directory with an mtime-validated in-memory cache."""

    def __init__(self, directory: str):
        self.dir = directory
        self.cache: dict = {}  # name -> (mtime, rawText, brief)

    def _path(self, filename: str) -> str:
        full = os.path.normpath(os.path.join(self.dir, filename))
        if not os.path.abspath(full).startswith(os.path.abspath(self.dir)):
            raise ValueError("preset path escapes store directory")
        return full

    def _refresh(self, name: str, filename: str):
        """Re-read one file if newer than cached; returns an error string
        for raw fetches of incompatible/broken files, else None."""
        full = self._path(filename)
        if not os.path.exists(full):
            return "missing"
        mtime = os.stat(full).st_mtime
        cached = self.cache.get(name)
        if cached and cached[0] >= mtime:
            return None
        try:
            with open(full, "r", encoding="utf-8") as fp:
                text = fp.read()
            item = json.loads(text)
            if compareVersion(version, item["version"]) < 0:
                return "Incompatible version"
            self.cache[item["name"]] = (mtime, text, getBrief(item))
            return None
        except Exception as e:
            return str(e)

    def fetch(self, name: str):
        """Raw JSON text of one preset, or an error string, or None."""
        if name in self.cache:
            return self.cache[name][1]
        err = self._refresh(name, name + ".json")
        if err == "missing":
            return None
        if err:
            return err
        entry = self.cache.get(name)
        return entry[1] if entry else None

    def brief(self, filename: str):
        if not filename.endswith(".json"):
            return None
        name = filename.rpartition(".")[0]
        if self._refresh(name, filename):
            return None
        entry = self.cache.get(name)
        return entry[2] if entry else None

    def listBriefs(self):
        if not os.path.exists(self.dir):
            return []
        return [b for b in map(self.brief, os.listdir(self.dir)) if b]

    def save(self, data: str) -> str:
        brief = getBrief(json.loads(data))
        name = brief["name"]
        os.makedirs(self.dir, exist_ok=True)
        with open(self._path(name + ".json"), "w", encoding="utf-8") as fp:
            fp.write(data)
        self.cache[name] = (time.time(), data, brief)
        return name


_stores: dict = {}


def _store(pType: str) -> PresetStore:
    if pType not in _stores:
        _stores[pType] = PresetStore(".user/preset_" + pType)
    return _stores[pType]


def initPreset(cfg):
    global version
    if "version" in cfg:
        version = cfg["version"]


def handlePreset(values):
    """(body, status) for the /preset endpoint."""
    try:
        pType = values.get("path")
        if pType not in PRESET_TYPES:
            return "", 403
        store = _store(pType)
        if values.get("data"):
            return store.save(values["data"]), 200
        if values.get("name"):
            text = store.fetch(values["name"])
            return (text, 200) if text else ("", 404)
        return json.dumps(store.listBriefs(), **COMPACT), 200
    except Exception:  # any malformed request is refused
        return "", 403
