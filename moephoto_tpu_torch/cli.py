"""Headless CLI: run a step chain on images or a video without the HTTP
server.

Examples:
    python -m moephoto_tpu_torch.cli image in.png out.png \
        --steps '[{"op":"SR","model":"lite","scale":4}]'
    python -m moephoto_tpu_torch.cli image 'shots/*.png' outdir/ --preset sr
    python -m moephoto_tpu_torch.cli video in.mkv out.mkv \
        --steps '[{"op":"slomo","model":"IFRNet M","sf":2}]'
    python -m moephoto_tpu_torch.cli video in.mkv out.mkv --steps '[{"op":"VSR"}]'

Video goes through ffmpeg (``ffmpegPath`` in ``.user/config.json``).

Runs on the CUDA device; set ``"device": "cpu"`` in ``.user/config.json``
to run on the CPU on purpose.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def loadPresetSteps(name: str, pType: str):
    path = os.path.join(".user", f"preset_{pType}", name + ".json")
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)["steps"]


class _Flag:
    """The stop flag of a CLI task: never set."""

    _s = False

    def is_set(self):
        return self._s

    def set(self):
        self._s = True

    def clear(self):
        self._s = False


def runImage(src: str, dst: str, steps):
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.runtime.context import context

    context.imageMode = "RGB"
    context.stopFlag = _Flag()
    with open(src, "rb") as fp:
        data = fp.read()
    context.sharedView = memoryview(data)
    chain = [{"op": "file"}] + [dict(s) for s in steps] + (
        [] if steps and steps[-1].get("op") == "output" else [{"op": "output"}]
    )
    chain[-1]["file"] = dst
    process, _ = genProcess(chain)
    process(len(data), name=dst)
    return dst


def runVideo(src: str, dst: str, steps):
    """Run ``steps`` over the video ``src`` into ``dst``: returns (output
    path, frames read)."""
    from moephoto_tpu_torch.runtime.context import context
    from moephoto_tpu_torch.video.engine import SR_vid

    context.stopFlag = _Flag()
    context.notifier = None
    chain = [dict(s) for s in steps]
    ops = [s.get("op") for s in chain]
    if not ops or ops[0] != "decode":
        chain.insert(0, {"op": "decode"})
    if "range" not in ops:
        chain.insert(1, {"op": "range"})
    if chain[-1].get("op") != "output":
        chain.append({"op": "output"})
    chain[-1]["file"] = dst
    return SR_vid(src, True, *chain)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=("image", "video"))
    ap.add_argument("src", help="input file or glob")
    ap.add_argument("dst", help="output file, or directory for globs")
    ap.add_argument("--steps", help="step-JSON list")
    ap.add_argument("--preset", help="preset name from .user/preset_*")
    args = ap.parse_args(argv)

    if args.preset:
        steps = loadPresetSteps(args.preset, args.kind)
        steps = [s for s in steps if s.get("op") not in ("decode", "range")]
    elif args.steps:
        steps = json.loads(args.steps)
    else:
        ap.error("one of --steps / --preset required")

    if args.kind == "video":
        out, frames = runVideo(args.src, args.dst, steps)
        print(f"{out} ({frames} frames)")
        return

    srcs = sorted(glob.glob(args.src)) or [args.src]
    if len(srcs) > 1 or os.path.isdir(args.dst):
        os.makedirs(args.dst, exist_ok=True)
        for s in srcs:
            print(runImage(s, os.path.join(args.dst, os.path.basename(s)), steps))
    else:
        print(runImage(srcs[0], args.dst, steps))


if __name__ == "__main__":
    main()
