"""The port's tile engine and executor (moephoto_tpu_torch/engine/)
against the JAX package's, tiled against tiled on a non-aligned image.

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
