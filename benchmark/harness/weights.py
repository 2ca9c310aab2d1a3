"""Seeded weights for a reference model, made on the device in one draw.

Every leaf of the model's state dict is a slice of one normal draw,
scaled and shifted by its kind: a convolution's weight by ``gain`` over
the square root of its fan-in (a transposed convolution's fan-in is
divided by its stride squared), a bias by ``bias_std``, a PReLU slope
around ``prelu[0]`` by ``prelu[1]``.  ``leaf_init`` maps glob patterns of
leaf names to a ``gain`` and a ``mean_per_fan_in`` (the mean is that over
the fan-in) for the convolution weights they match, the first match
winning: a branch whose weights average their inputs passes the image
through, so a random model's output stays in range.  The result is cast
to the type the configuration serves in.
"""

from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Dict

import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leafRules(model: nn.Module, rule: dict):
    gain, biasStd = float(rule.get("gain", 1.0)), float(rule.get("bias_std", 0.01))
    preluMean, preluStd = rule.get("prelu", [0.25, 0.0])
    leafInit = rule.get("leaf_init", {})
    out = []
    for modName, mod in model.named_modules():
        for pName, p in mod.named_parameters(recurse=False):
            key = f"{modName}.{pName}" if modName else pName
            if isinstance(mod, nn.PReLU):
                mean, std = float(preluMean), float(preluStd)
            elif pName == "bias":
                mean, std = 0.0, biasStd
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                if isinstance(mod, nn.ConvTranspose2d):
                    cin, _, kh, kw = p.shape
                    fanIn = cin * kh * kw / (mod.stride[0] * mod.stride[1])
                else:
                    _, cin, kh, kw = p.shape
                    fanIn = cin * kh * kw
                init = next((v for pat, v in leafInit.items() if fnmatchcase(key, pat)), {})
                mean = float(init.get("mean_per_fan_in", 0.0)) / fanIn
                std = float(init.get("gain", gain)) / fanIn**0.5
            else:
                raise TypeError(f"no weight rule for {key} of {type(mod).__name__}")
            out.append((key, tuple(p.shape), mean, std))
    return out


def drawWeights(model: nn.Module, rule: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (any device, meta too) from ``seed``: one
    draw on ``device``, leaves as views of it, in ``dtype``."""
    leaves = _leafRules(model, rule)
    counts = torch.tensor([torch.Size(s).numel() for _, s, _, _ in leaves], device=device)
    std = torch.repeat_interleave(torch.tensor([s for *_, s in leaves], device=device), counts)
    mean = torch.repeat_interleave(torch.tensor([m for _, _, m, _ in leaves], device=device), counts)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
    flat = (torch.randn(int(counts.sum()), generator=g, device=device) * std + mean).to(dtype)
    sd, at = {}, 0
    for key, shape, _, _ in leaves:
        n = torch.Size(shape).numel()
        sd[key] = flat[at : at + n].view(shape)
        at += n
    return sd
