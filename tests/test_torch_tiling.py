"""The port's tile engine and executor (moephoto_tpu_torch/engine/)
against the JAX package's, tiled against tiled on a non-aligned image;
and the chunk blend (``ops/blend.py``): its per-tile loop against the
kernel's pass written in torch ops, bit for bit.

Tolerance: 2e-5 absolute in fp32 for model outputs (as in
test_torch_lite.py; the blend is a convex combination of them), 1e-6 for
the sigmoid windows (one fp32 sigmoid each side)."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _lite2Params
from moephoto_tpu.engine import executor as jaxExec
from moephoto_tpu.engine import tiling as jaxTiling
from moephoto_tpu.models import sr as jaxSr
from moephoto_tpu.models.api import conv2d as jaxConv2d
from moephoto_tpu.models.api import packBlockDiag as jaxPackBlockDiag
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.engine import executor, tiling
from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.models.sr import MoeNetLite2
from moephoto_tpu_torch.ops import blend
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


@pytest.mark.parametrize("size,tile,pad,align", [(70, 32, 5, 8), (50, 32, 5, 8), (1080, 256, 5, 8),
                                                 (1920, 256, 5, 8), (20, 32, 5, 8), (300, 128, 16, 16)])
def test_plan_and_windows_match_jax(size, tile, pad, align):
    assert tiling.planAxis(size, tile, pad) == jaxTiling.planAxis(size, tile, pad)
    assert tiling.paddedExtent(size, tile, pad, align) == jaxTiling.paddedExtent(size, tile, pad, align)
    for padSc in (0, pad, pad * 4):
        for edges in ((False,) * 4, (True, False, False, True), (True,) * 4):
            got = tiling.blendWindow(tile, tile + 8, padSc, edges).numpy()
            ref = np.asarray(jaxTiling.blendWindow(tile, tile + 8, padSc, edges=edges))
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_reflect_pad_repeats_like_jax():
    """Pads larger than the image repeat the reflection; a 1-pixel axis
    falls back to edge padding."""
    import jax.numpy as jnp

    x = np.random.RandomState(0).rand(5, 7, 3).astype(np.float32)
    for ph, pw in ((3, 2), (11, 20), (0, 9)):
        got = tiling.reflectPadHW(torch.from_numpy(x), ph, pw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jaxTiling.reflectPadHW(jnp.asarray(x), ph, pw)))
    one = x[:1]
    got = tiling.reflectPadHW(torch.from_numpy(one), 4, 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaxTiling.reflectPadHW(jnp.asarray(one), 4, 3)))


class _Conv3(torch.nn.Module):
    """A scale-1 NHWC test model: one 3x3 conv with bias."""

    def __init__(self, sd):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 3, 3, padding=1)
        self.load_state_dict({"c.weight": sd["c.weight"], "c.bias": sd["c.bias"]})

    def forward(self, x):
        return self.c(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _liteCase(pack):
    import jax.numpy as jnp

    jp = {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in _lite2Params(4, seed=3, random=True).items()}
    if pack:
        jp = jaxPackBlockDiag(jp, pack)
    model = MoeNetLite2(4, pack=max(pack, 1))
    model.load_state_dict(fromJaxParams({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return jaxSr.makeMoeNetLite2(4), jp, model


@pytest.mark.parametrize("case", ["split_ensemble2", "pack2", "rgba", "strength"])
def test_model_exec_matches_jax(case):
    """70x50 on 32-px tiles: 3x2 tiles, batch 3 or 4, ensemble transposes the
    image.  Pad 4, not 5: at pad 5 the JAX engine fails on this image
    (see test_tile_plan_covers_image_where_jax_overshoots)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    x = rng.rand(70, 50, 4 if case == "rgba" else 3).astype(np.float32)
    kw = {}
    if case == "strength":
        w = (rng.randn(3, 3, 3, 3) * 0.2).astype(np.float32)
        jp = {"c.weight": jnp.asarray(w), "c.bias": jnp.asarray(rng.randn(3).astype(np.float32) * 0.1)}
        japply = lambda p, t: jaxConv2d(p, "c", t, padding=1)
        model = _Conv3(fromJaxParams({k: np.asarray(v) for k, v in jp.items()}))
        spec = dict(tile=32, pad=4, align=8, scale=1.0, batch=3)
        kw = dict(strength=0.7)
    else:
        pack = 2 if case == "pack2" else 0
        japply, jp, model = _liteCase(pack)
        # packing pairs planes across the chunk: batch * 3 channels must be even
        spec = dict(tile=32, pad=4, align=8, scale=4.0, batch=4 if pack else 3)
        kw = dict(pack=2) if pack else dict(channelSplit=True)
        if case == "split_ensemble2":
            kw["ensemble"] = 2
    jex = jaxExec.ModelExec(japply, jp, jaxTiling.TileSpec(**spec), dtype=jnp.float32, **kw)
    pex = executor.ModelExec(model, tiling.TileSpec(**spec), dtype=torch.float32, **kw)
    if case == "rgba":
        ref = np.asarray(jaxExec.rgbFilter(jex)(jnp.asarray(x)))
        got = executor.rgbFilter(pex)(torch.from_numpy(x)).numpy()
    else:
        ref = np.asarray(jex(jnp.asarray(x)))
        got = pex(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_tile_plan_covers_image_where_jax_overshoots():
    """50 px at tile 32, pad 5, align 8: the padded extent is 56 and the
    JAX engine re-plans three anchors on it, the last past the end, so
    its tiles differ in size.  The port plans on the image's extent."""
    assert jaxTiling.planAxis(jaxTiling.paddedExtent(50, 32, 5, 8), 32, 5) == [0, 22, 44]
    x = torch.from_numpy(np.random.RandomState(2).rand(70, 50, 3).astype(np.float32))
    out = tiling.tiledApply(x, lambda t: t.repeat_interleave(4, 1).repeat_interleave(4, 2),
                            tiling.TileSpec(32, 5, 8, 4.0, 3))
    assert out.shape == (280, 200, 3)
    want = x.repeat_interleave(4, 0).repeat_interleave(4, 1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_model_exec_rejects_integer_images():
    ex = executor.ModelExec(lambda t: t, tiling.TileSpec(32, 5, 8, 1.0, 2), dtype=torch.float32)
    with pytest.raises(TypeError):
        ex(np.zeros((8, 8, 3), np.uint8))


def test_bf16_tiles_blend_on_fp32_canvas():
    """The JAX engine accumulates bf16 tiles on a bf16 canvas; the port
    blends on fp32, so an identity model returns its bf16 input exactly
    up to fp32 rounding, where a bf16 canvas is off by ~1e-2."""
    x = torch.from_numpy(np.random.RandomState(1).rand(70, 50, 3).astype(np.float32)).to(torch.bfloat16)
    out = tiling.tiledApply(x, lambda t: t, tiling.TileSpec(32, 5, 8, 1.0, 3))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), x.float().numpy(), atol=1e-6, rtol=0)


def _kernelAxis(t, padSc, first, last):
    """An axis's window as ``csrc/blend.cu`` ``axisWeight`` computes it,
    pixel by pixel from the ramp table: 1 when padSc is 0; else 0 below
    ``d`` and the ramp over the next ``r`` on a side that is not the
    image's first, then 0 from ``t - d`` and the mirrored ramp over the
    ``r`` before on a side that is not its last, which wins where they
    meet; 1 elsewhere."""
    if padSc == 0:
        return torch.ones(t)
    d, r = blend.rampSpan(padSc)
    table = blend.ramp(r).tolist()
    w = []
    for i in range(t):
        v = 1.0
        if not first:
            v = 0.0 if i < d else table[i - d] if i < d + r else v
        if not last:
            v = 0.0 if i >= t - d else table[t - d - 1 - i] if i >= t - d - r else v
        w.append(v)
    return torch.tensor(w, dtype=torch.float32)


def _kernelBlend(canvas, weight, tiles, origins, edges, padSc):
    """``csrc/blend.cu``'s pass over a chunk in torch ops: the canvas and
    weight of the chunk's bounding box read once, each tile's window by
    ``_kernelAxis`` (``w = wy * wx``), the covering tiles' terms
    (``c + float(t) * w``, ``wt + w``) added in chunk order, the box
    written back once."""
    th, tw = tiles.shape[1:3]
    ya, xa = min(oy for oy, _ in origins), min(ox for _, ox in origins)
    yb, xb = max(oy for oy, _ in origins) + th, max(ox for _, ox in origins) + tw
    acc, wt = canvas[ya:yb, xa:xb].clone(), weight[ya:yb, xa:xb].clone()
    for (oy, ox), e, tile in zip(origins, edges, tiles):
        w = (_kernelAxis(th, padSc, e[0], e[1])[:, None] * _kernelAxis(tw, padSc, e[2], e[3])[None, :])[:, :, None]
        box = (slice(oy - ya, oy - ya + th), slice(ox - xa, ox - xa + tw))
        acc[box] = acc[box] + tile.float() * w
        wt[box] = wt[box] + w
    canvas[ya:yb, xa:xb] = acc
    weight[ya:yb, xa:xb] = wt


def _blendPlan(h, w, spec, outC, dtype, layout, seed):
    """``tiledApply``'s plan for an (h, w) image: the canvas's shape, padSc,
    and per chunk its padded tile outputs (``split``: the channel-split
    planes' strides, channel stride oth * otw), origins and edges."""
    tile, pad, align, sc = spec.tile, spec.pad, spec.align, spec.scale
    ph, pw = (tiling.paddedExtent(n, tile, pad, align) for n in (h, w))
    ys, xs = tiling.planAxis(h, tile, pad), tiling.planAxis(w, tile, pad)
    oth, otw = int(round(min(tile, ph) * sc)), int(round(min(tile, pw) * sc))
    places = [((int(round(y * sc)), int(round(xc * sc))), (iy == 0, iy == len(ys) - 1, ix == 0, ix == len(xs) - 1))
              for iy, y in enumerate(ys) for ix, xc in enumerate(xs)]
    g = torch.Generator().manual_seed(seed)
    chunks = []
    for start in range(0, len(places), spec.batch):
        part = places[start : start + spec.batch]
        if layout == "split":
            tiles = torch.rand((spec.batch, outC, oth, otw), generator=g).to(dtype).permute(0, 2, 3, 1)
        else:
            tiles = torch.rand((spec.batch, oth, otw, outC), generator=g).to(dtype)
        chunks.append((tiles, [o for o, _ in part], [e for _, e in part]))
    return (int(round(ph * sc)), int(round(pw * sc)), outC), int(round(pad * sc)), chunks


# (h, w, TileSpec, channels, tile dtype, layout): one-tile and many-tile
# axes, padded last chunks, scales 1, 2 and 4, padSc 0 and > 0
BLEND_PLANS = {
    "one_tile_x1_f32": (20, 24, tiling.TileSpec(32, 5, 8, 1.0, 3), 3, torch.float32, "nhwc"),
    "grid_x4_bf16_split": (70, 50, tiling.TileSpec(32, 5, 8, 4.0, 4), 3, torch.bfloat16, "split"),
    "grid_x2_f32_split": (70, 50, tiling.TileSpec(32, 4, 8, 2.0, 4), 3, torch.float32, "split"),
    "grid_x1_pad0_bf16": (70, 50, tiling.TileSpec(32, 0, 8, 1.0, 4), 3, torch.bfloat16, "nhwc"),
    "row_x4_bf16_split": (20, 90, tiling.TileSpec(32, 5, 8, 4.0, 2), 3, torch.bfloat16, "split"),
    "grid_x1_wide_halo_f32": (300, 180, tiling.TileSpec(128, 16, 16, 1.0, 3), 4, torch.float32, "nhwc"),
    "one_chunk_x4_bf16_split": (60, 60, tiling.TileSpec(32, 5, 8, 4.0, 10), 1, torch.bfloat16, "split"),
}


def _blendPlainMatchesKernel(name):
    h, w, spec, outC, dtype, layout = BLEND_PLANS[name]
    shape, padSc, chunks = _blendPlan(h, w, spec, outC, dtype, layout, seed=len(name))
    got = (torch.zeros(shape), torch.zeros(shape[:2] + (1,)))
    want = (torch.zeros(shape), torch.zeros(shape[:2] + (1,)))
    for tiles, origins, edges in chunks:
        blend.blendTiles(*got, tiles, origins, edges, padSc)  # the CPU takes blendTilesPlain
        _kernelBlend(*want, tiles, origins, edges, padSc)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    sc = spec.scale
    assert bool((want[1][: int(h * sc), : int(w * sc)] > 0).all())  # every output pixel was blended


def _windowRuleMatchesBlendWindow():
    """The kernel's per-pixel rule (``_kernelAxis``) against the engine's
    window (``axisWindow``'s slice assignments, held against JAX by
    test_plan_and_windows_match_jax), value for value, and their product
    against ``blendWindow``."""
    for t, padSc in ((32, 0), (32, 1), (32, 5), (40, 20), (128, 16), (1024, 20), (25, 16), (9, 5)):
        for edges in ((False,) * 4, (True, False, False, True), (False, True, True, False), (True,) * 4):
            wy = _kernelAxis(t, padSc, edges[0], edges[1])
            wx = _kernelAxis(t + 8, padSc, edges[2], edges[3])
            assert torch.equal(wy, blend.axisWindow(t, padSc, edges[0], edges[1]))
            assert torch.equal(wx, blend.axisWindow(t + 8, padSc, edges[2], edges[3]))
            assert torch.equal(wy[:, None] * wx[None, :], tiling.blendWindow(t, t + 8, padSc, edges))


def _rampUploadedOnce(monkeypatch):
    """``rampOn`` copies a padSc's table to a device once and keeps it:
    ``moe.count.blend_uploads=1`` on the first call, nothing on the
    second; a ``tiledApply`` on the CPU makes no table and records no
    upload (its windows are ``blendWindow``'s, on the host)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(blend, "_tables", {})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = blend.rampOn(6, "cpu")
        again = blend.rampOn(6, "cpu")
    uploads = [e.name for e in prof.events() if e.name.startswith("moe.count.blend_")]
    assert uploads == ["moe.count.blend_uploads=1"] and again is first
    assert torch.equal(first, blend.ramp(6)) and list(blend._tables) == [(6, torch.device("cpu"))]

    monkeypatch.setattr(blend, "_tables", {})
    up = lambda t: t.repeat_interleave(2, 1).repeat_interleave(2, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiling.tiledApply(torch.rand(40, 36, 3), up, tiling.TileSpec(16, 3, 4, 2.0, 4))
    assert not [e.name for e in prof.events() if e.name.startswith("moe.count.blend_")] and not blend._tables


@pytest.mark.parametrize("case", [*BLEND_PLANS, "window_rule", "ramp_cache"])
def test_chunk_blend(case, monkeypatch):
    """The chunk blend on the CPU: ``blendTilesPlain`` (through
    ``blendTiles``) bit-equal to the kernel's pass written in torch ops on
    each plan of BLEND_PLANS, chunk after chunk; the kernel's window rule
    against the engine's window; the ramp table copied once per padSc and
    device."""
    if case == "window_rule":
        _windowRuleMatchesBlendWindow()
    elif case == "ramp_cache":
        _rampUploadedOnce(monkeypatch)
    else:
        _blendPlainMatchesKernel(case)
