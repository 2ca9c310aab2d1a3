"""Model executor: tiled inference with precision policy, channel
folding, plane packing, self-ensemble and strength blending.

On the card a model that lists its forward pass as ``stages()`` (span
name, function) pairs, as ``models/nafnet.NAFNet`` and
``models/mprnet.MPRNet`` do, runs each full chunk (``batch`` tiles of
``tile`` x ``tile``, every chunk of an image at least a tile high and
wide) as one CUDA graph a stage, captured on the first such chunk:
NAFNet-SIDD-32 issues ~880 small kernels a chunk and MPRNet ~740, which
Python issued more slowly than an H100 ran them.  A replay runs the same
kernels in the same order.  The exec keeps one capture, and captures
anew when the chunk's shape, the model's weights or the TF32 settings
change; smaller chunks, models without stages and the CPU run eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine.tiling import TileSpec, ceilTo, reflectPadHW, tiledApply
from moephoto_tpu_torch.parallel.mesh import activeMesh, replicaOn
from moephoto_tpu_torch.progress import span

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
        self._graphs: Optional[StageGraphs] = None  # the full chunk's, on the card
        self._weights: Optional[tuple] = None  # weightsKey, read once a call

    @property
    def scale(self) -> float:
        return self.spec.scale

    def _tileFn(self, t: torch.Tensor) -> torch.Tensor:
        b, th, tw, c = t.shape
        model = replicaOn(self.model, t.device)  # a mesh device's tiles: the model's copy there
        if self.pack:
            p = self.pack
            if (b * c) % p:
                raise ValueError(f"{b} tiles x {c} channels do not pack by {p}")
            planes = t.permute(0, 3, 1, 2).reshape(b * c // p, p, th, tw).permute(0, 2, 3, 1)
            out = self._run(model, planes)
            _, oh, ow, oc = out.shape
            return out.permute(0, 3, 1, 2).reshape(b, c, oh, ow).permute(0, 2, 3, 1)
        if not self.channelSplit:
            return self._run(model, t)
        planes = t.permute(0, 3, 1, 2).reshape(b * c, th, tw, 1)
        out = self._run(model, planes)
        _, oh, ow, _ = out.shape
        return out.reshape(b, c, oh, ow).permute(0, 2, 3, 1)

    def _run(self, model: Callable, t: torch.Tensor) -> torch.Tensor:
        """``model(t)``; a full chunk of a model with stages on the card
        replays its graphs (the module's docstring)."""
        stages = getattr(model, "stages", None)
        if stages is None or model is not self.model or not t.is_cuda or t.shape[1:3] != (self.spec.tile,) * 2:
            return model(t)
        if self._weights is None:
            self._weights = weightsKey(model)
        key = (tuple(t.shape), t.stride(), t.dtype, t.device, self._weights)
        if self._graphs is None or self._graphs.key != key:
            self._graphs = None  # its memory pool goes before the next capture
            self._graphs = StageGraphs(stages(), t, key)
        return self._graphs(t)

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
        self._weights = None
        outC = self.outC or x.shape[-1]
        mesh = activeMesh()  # config.meshShape's mesh spreads the tile batch; None: single device
        run = lambda img: tiledApply(img, self._tileFn, self.spec, outC, mesh)
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
        image): pad to alignment, run once, crop.  Single-device, as in the
        JAX package (``engine/executor.py:189-195``): there is no tile batch
        to spread, and ``config.meshShape`` only reaches the tiled path."""
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


def weightsKey(model: torch.nn.Module) -> tuple:
    """What a capture of ``model`` reads besides its input: the TF32
    settings and the weights' addresses."""
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            tuple(p.data_ptr() for p in model.parameters()))


class StageGraphs:
    """``stages`` ((span name, function) pairs, each function taking the
    result of the one before) captured as one CUDA graph each for inputs
    like ``inp``, on static tensors: ``inp`` (written before a replay),
    each stage's result, ``out`` (copied out after one).  The graphs share
    one memory pool and replay in the order they were captured, each in
    its span.  Before capture the stages run once on the capturing stream,
    so that cuDNN and cuBLAS set up their handles and workspaces outside
    it.  ``key`` is what the capture holds fixed (``ModelExec._run``: the
    input's shape, strides, dtype and device, and ``weightsKey``)."""

    def __init__(self, stages, inp: torch.Tensor, key=None):
        self.key, self.inp = key, inp.clone()
        dev = inp.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            state = self.inp
            for _, fn in stages:
                state = fn(state)
        torch.cuda.current_stream(dev).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.results, state = [], [], self.inp
        for name, fn in stages:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
                state = fn(state)
            self.graphs.append((name, g))
            self.results.append(state)  # the next stage's graph reads it
        self.out = state

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.inp.copy_(x)
        for name, g in self.graphs:
            with span(name):
                g.replay()
        return self.out.clone()


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
