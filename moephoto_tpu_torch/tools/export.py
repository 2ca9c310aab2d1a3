"""Export a zoo model to a ``torch.export`` program (``.pt2``) for
deployment: the counterpart of the JAX package's
``tools/export_stablehlo.py``, with the same arguments, lookup, function
and line.

Usage: python -m moephoto_tpu_torch.tools.export lite2 [out.pt2] [H W]

Any key of the SR, DN and dehaze registries (``lite2``, ``lite4``,
``dehaze``, ``AiLUT_sRGB_3``, ...).  The program is the registry exec's
model on one (1, H, W, 1 or 3) fp32 image, cast to the exec's dtype and
back to fp32, with static shapes, on the configured device: the card,
unless the config asks for the CPU.  No ``prepare`` map and no tiling, as
in the JAX tool.  On the card the hand-written kernels K1
(``moephoto_torch::fused_up_heads``) and K4
(``moephoto_torch::ailut_transform``) are single nodes of the program; on
the CPU their plain versions trace as ordinary ops.

:func:`loadExported` loads a file with the ops registered and returns its
callable.  The export records in the file whether the model is an fp32
registry entry (AiLUT): a graph does not record the process-wide TF32
flags under which ``AiLUT.generate`` pins its convs and linears to full
fp32 (``models.api.fullFp32``), so the loader runs such a program inside
``fullFp32()`` and gives the eager result bit for bit.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Callable, Optional

import torch
from torch import nn

META = "moephoto.json"  # the file's extra record: whether the model is an fp32 registry entry


def lookup(model: str) -> dict:
    """The registry entry of ``model`` in the SR, DN or dehaze registry."""
    from moephoto_tpu_torch.pipeline import registry

    entry = registry.SR_REGISTRY.get(model) or registry.DN_REGISTRY.get(model) or registry.DEHAZE_REGISTRY.get(model)
    if entry is None:
        raise SystemExit(f"unknown model {model}")
    return entry


class Program(nn.Module):
    """An exec's model as the export traces it: fp32 image in, cast to
    ``dtype``, the model, fp32 out."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype)).float()


def exportModel(model: str, out: Optional[str] = None, h: int = 256, w: int = 256):
    """Export registry ``model`` at (1, h, w, cIn) to ``out`` (default
    ``<model>.pt2``); returns ``(exportedProgram, out)``.

    One eager call on the zeros input comes first: what a module prepares
    from its weights for its kernel (lite's K1 weights, ``MoeNetLite2.upWeights``)
    is made there, and the trace reads it as constants."""
    from moephoto_tpu_torch.pipeline import registry

    entry = lookup(model)
    out = out or f"{model}.pt2"
    ex = registry.buildExec(entry)
    cIn = 1 if entry["channelSplit"] else 3
    x = torch.zeros((1, h, w, cIn), dtype=torch.float32, device=ex.device)
    program = Program(ex.model, ex.dtype)
    with torch.no_grad():
        program(x)
        exported = torch.export.export(program, (x,))
    exported.example_inputs = None  # else the file carries the zeros input (25 MB at 1080p RGB fp32)
    torch.export.save(exported, out, extra_files={META: json.dumps({"fp32": bool(entry["fp32"])})})
    return exported, out


def loadExported(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The callable of the program in ``path``, with the port's ops
    registered: it runs the program without autograd, and an fp32 entry's
    program inside ``fullFp32()``."""
    from moephoto_tpu_torch.models.api import fullFp32
    from moephoto_tpu_torch.ops import fusedup, lut  # noqa: F401  (register the ops the program calls)

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra).module()
    precision = fullFp32 if json.loads(extra[META])["fp32"] else contextlib.nullcontext

    def run(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), precision():
            return program(x)

    return run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    model = argv[0] if len(argv) > 0 else "lite2"
    out = argv[1] if len(argv) > 1 else f"{model}.pt2"
    h = int(argv[2]) if len(argv) > 2 else 256
    w = int(argv[3]) if len(argv) > 3 else 256
    _, out = exportModel(model, out, h, w)
    print(f"exported {model} -> {out} ({os.path.getsize(out)} bytes)")
    return out


if __name__ == "__main__":
    main()
