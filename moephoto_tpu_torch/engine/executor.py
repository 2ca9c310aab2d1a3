"""Model executor: tiled inference with precision policy, channel
folding, plane packing, self-ensemble and strength blending."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.tiling import TileSpec, ceilTo, reflectPadHW, tiledApply

# The 8 dihedral symmetries used by self-ensemble, on HWC.
_transpose = lambda x: x.transpose(0, 1)
_flip = lambda x: x.flip(1)
_flip2 = lambda x: x.flip(0, 1)

# (forward, inverse) pairs; forward applied before the model, inverse after.
ENSEMBLE_TRANSFORMS: Tuple[Tuple[Callable, Callable], ...] = (
    (_transpose, _transpose),
    (_flip, _flip),
    (_flip2, _flip2),
    (lambda x: _transpose(_flip(x)), lambda x: _flip(_transpose(x))),
    (lambda x: _flip(_transpose(x)), lambda x: _transpose(_flip(x))),
    (lambda x: _transpose(_flip2(x)), lambda x: _flip2(_transpose(x))),
    (lambda x: _flip2(_transpose(x)), lambda x: _transpose(_flip2(x))),
)


class ModelExec:
    """A ready-to-run model: ``exec(image_hwc) -> image_hwc`` (fp32, on
    the model's device).

    Args:
      model: batched NHWC model ``(B, th, tw, C) -> (B, th*s, tw*s, outC)``,
        its parameters already on ``device`` in ``dtype``.
      spec: static tile spec.
      channelSplit: Y-channel models: fold image channels into the tile
        batch, each processed as a (th, tw, 1) plane.
      outC: output channels (default: input channels).
      prepare: optional pre-model map on the full image.
      strength: blend factor with the input.
      ensemble: number of extra dihedral transforms to average (0-7).
      pack: > 0 runs a Y-channel model plane-packed: ``pack`` planes ride
        the channel axis of a model built with block-diagonal weights.
    """

    def __init__(
        self,
        model: Callable,
        spec: TileSpec,
        channelSplit: bool = False,
        outC: Optional[int] = None,
        prepare: Optional[Callable] = None,
        strength: float = 1.0,
        ensemble: int = 0,
        dtype: Optional[torch.dtype] = None,
        name: str = "",
        pack: int = 0,
        device=None,
    ):
        self.model = model
        self.spec = spec
        self.channelSplit = channelSplit
        self.outC = outC
        self.prepare = prepare
        self.strength = float(strength)
        self.ensemble = int(ensemble)
        self.dtype = dtype or config.dtype()
        self.name = name
        self.pack = int(pack)
        self.device = torch.device(device) if device is not None else config.torchDevice()

    @property
    def scale(self) -> float:
        return self.spec.scale

    def _tileFn(self, t: torch.Tensor) -> torch.Tensor:
        b, th, tw, c = t.shape
        if self.pack:
            p = self.pack
            if (b * c) % p:
                raise ValueError(f"{b} tiles x {c} channels do not pack by {p}")
            planes = t.permute(0, 3, 1, 2).reshape(b * c // p, p, th, tw).permute(0, 2, 3, 1)
            out = self.model(planes)
            _, oh, ow, oc = out.shape
            return out.permute(0, 3, 1, 2).reshape(b, c, oh, ow).permute(0, 2, 3, 1)
        if not self.channelSplit:
            return self.model(t)
        planes = t.permute(0, 3, 1, 2).reshape(b * c, th, tw, 1)
        out = self.model(planes)
        _, oh, ow, _ = out.shape
        return out.reshape(b, c, oh, ow).permute(0, 2, 3, 1)

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if not x.is_floating_point():
            raise TypeError("ModelExec expects a float image in [0, 1]")
        return x.to(self.device)

    @torch.inference_mode()
    def __call__(self, x) -> torch.Tensor:
        inp = self._input(x)
        x = self.prepare(inp) if self.prepare is not None else inp
        x = x.to(self.dtype)
        outC = self.outC or x.shape[-1]
        run = lambda img: tiledApply(img, self._tileFn, self.spec, outC)
        y = run(x)
        if self.ensemble:
            for fwd, inv in ENSEMBLE_TRANSFORMS[: self.ensemble]:
                y = y + inv(run(fwd(x)))
            y = y / (self.ensemble + 1)
        if self.strength != 1.0 and y.shape == inp.shape:
            y = self.strength * y + (1.0 - self.strength) * inp.float()
        return y

    @torch.inference_mode()
    def applyWhole(self, x) -> torch.Tensor:
        """Un-tiled path (for models whose output depends on the whole
        image): pad to alignment, run once, crop."""
        inp = self._input(x)
        x = self.prepare(inp) if self.prepare is not None else inp
        x = x.to(self.dtype)
        h, w = x.shape[0], x.shape[1]
        ph, pw = ceilTo(h, self.spec.align), ceilTo(w, self.spec.align)
        xp = reflectPadHW(x, ph - h, pw - w)
        y = self.model(xp[None])[0]
        sc = self.spec.scale
        y = y[: int(round(h * sc)), : int(round(w * sc))].float()
        if self.strength != 1.0 and y.shape == inp.shape:
            y = self.strength * y + (1.0 - self.strength) * inp.float()
        return y


def rgbFilter(exec_: Callable) -> Callable:
    """Step function with alpha passthrough around ``exec_`` (a
    :class:`ModelExec` or its ``applyWhole``): a trailing alpha channel
    bypasses the model and is re-attached, nearest-resized if the model
    scales (``nearest-exact`` samples pixel centres, as
    ``jax.image.resize`` does, for integer and fractional scales)."""

    def f(im):
        im = torch.as_tensor(im)
        alpha = None
        if im.shape[-1] == 4:
            alpha = im[..., 3:]
            im = im[..., :3]
        out = exec_(im)
        if alpha is not None:
            alpha = alpha.to(out.device, torch.float32)
            if alpha.shape[:2] != out.shape[:2]:
                a = alpha.permute(2, 0, 1)[None]
                a = F.interpolate(a, size=tuple(out.shape[:2]), mode="nearest-exact")
                alpha = a[0].permute(1, 2, 0)
            out = torch.cat([out, alpha], dim=-1)
        return out

    return f
