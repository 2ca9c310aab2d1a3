"""The port's IconVSR (moephoto_tpu_torch/models/iconvsr.py) against the
JAX package's (moephoto_tpu/models/iconvsr.py): SpyNet, EDVR (PCD and
TSA), the trunks, the upsampler and the whole ``doVSR`` stream, on
``synthIconVSRParams`` weights (torch layout) carried to JAX by its
``convertStateDict``, with the trunks at 2 residual blocks.

Tolerance 5e-5 * max(1, |ref|) elementwise, fp32 on the CPU with JAX at
``highest`` precision: both compute the same convolutions, warps and
deformable samples in sums of another order, and a warp or a DCN turns a
coordinate that differs in the last bits into a value difference of that
size times the local gradient.  The JAX DCNs run as ``deformConv2d``
dispatches them on the CPU (the window tiers, or the gather beyond 3 px).
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.models import api as JA
from moephoto_tpu.models import iconvsr as J
from moephoto_tpu.models.api import convertStateDict
from moephoto_tpu.progress import Node as JaxNode
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import iconvsr as P
from moephoto_tpu_torch.models.api import conv
from moephoto_tpu_torch.ops.deform import deformConv2d
from moephoto_tpu_torch.progress import Node
from moephoto_tpu_torch.synth import synthIconVSRParams
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

TOL = 5e-5
BLOCKS = 2


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's IconVSR with the same weights)."""
    import jax.numpy as jnp

    raw = synthIconVSRParams(0, BLOCKS)
    sd = {f"{mod}.{k}": v for mod, msd in raw.items() for k, v in msd.items()}
    jp = {k: jnp.asarray(v) for k, v in convertStateDict({k: v.numpy() for k, v in sd.items()}).items()}
    model = P.IconVSR(P.trunkBlocks(sd))
    model.load_state_dict(sd, strict=True)
    return jp, model.eval()


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(ref))), float(err.max())


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# (port op, JAX op, input shape): the layer ops IconVSR's modules use, at
# odd sizes where padding and edges matter
LAYER_OPS = {
    "pixelShuffle_r2": (lambda x: PA.pixelShuffle(x, 2), lambda x: JA.pixelShuffle(x, 2), (2, 5, 7, 12)),
    "avgPool2d_2_exclude_pad": (lambda x: PA.avgPool2d(x, 2, 2, count_include_pad=False),
                                lambda x: JA.avgPool2d(x, 2, 2, count_include_pad=False), (2, 8, 12, 3)),
    "avgPool2d_3_s2_p1": (lambda x: PA.avgPool2d(x, 3, 2, 1), lambda x: JA.avgPool2d(x, 3, 2, 1), (2, 9, 12, 8)),
    "avgPool2d_3_s2_p1_exclude_pad": (lambda x: PA.avgPool2d(x, 3, 2, 1, count_include_pad=False),
                                      lambda x: JA.avgPool2d(x, 3, 2, 1, count_include_pad=False), (2, 9, 12, 8)),
    "maxPool2d_3_s2_p1": (lambda x: PA.maxPool2d(x, 3, 2, 1), lambda x: JA.maxPool2d(x, 3, 2, 1), (2, 9, 12, 8)),
    "resize_align_corners_up": (lambda x: PA.resizeBilinear(x, 8, 12, align_corners=True),
                                lambda x: JA.resizeBilinear(x, 8, 12, align_corners=True), (1, 4, 6, 2)),
    "resize_align_corners_down": (lambda x: PA.resizeBilinear(x, 5, 7, align_corners=True),
                                  lambda x: JA.resizeBilinear(x, 5, 7, align_corners=True), (1, 9, 13, 2)),
    "resize_2x_phase_form": (lambda x: PA.resizeBilinear(x, 2 * x.shape[1], 2 * x.shape[2]),
                             JA.resizeBilinear2x, (2, 5, 7, 4)),
    "leakyRelu_0.1": (lambda x: PA.leakyRelu(x, 0.1), lambda x: JA.leakyRelu(x, 0.1), (2, 3, 4, 5)),
    "sigmoid": (PA.sigmoid, JA.sigmoid, (2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", LAYER_OPS)
def test_layer_op_matches_jax(name):
    """NHWC layer ops against the JAX package's, on values of both signs
    (max pooling pads with -inf); within 1e-6, the same weighted sums of
    values under 5 in another order."""
    import jax.numpy as jnp

    portOp, jaxOp, shape = LAYER_OPS[name]
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    ref = np.asarray(jaxOp(jnp.asarray(x)))
    got = portOp(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_trunk_blocks_come_from_the_checkpoint(weights):
    assert len(weights[1].backward_trunk[2]) == len(weights[1].forward_trunk[2]) == BLOCKS


def test_spynet_matches_jax(weights):
    import jax.numpy as jnp

    pair = _rand(1, 2, 2, 64, 128, 3)
    pair[:, 1] = np.roll(pair[:, 0], (2, -3), axis=(1, 2)) * 0.9 + 0.1 * pair[:, 1]  # a shifted frame
    ref = J.spynetApply(weights[0], jnp.asarray(pair))
    with torch.inference_mode():
        got = weights[1].spynet(torch.from_numpy(pair))
    assert got.shape == (2, 64, 128, 2)
    _close(got.numpy(), ref)


def test_edvr_matches_jax(weights):
    """One 7-frame clip at 64x64 (PCD on a batch of 7): its four DCNs see
    offsets past the JAX package's 3 px window, so JAX runs them as
    gathers."""
    import jax.numpy as jnp

    x = _rand(2, 1, 7, 64, 64, 3)
    ref = J.edvrApply(weights[0], jnp.asarray(x))
    model = weights[1]
    calls, before = model.edvr.calls, deformConv2d.launches
    with torch.inference_mode():
        got = model.edvr(torch.from_numpy(x))
    assert model.edvr.calls == calls + 1 and deformConv2d.launches == before  # the plain path on the CPU
    assert got.shape == (1, 64, 64, 64)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("trunk,cin", [("backward_trunk", 67), ("forward_trunk", 131)])
def test_trunk_matches_jax(weights, trunk, cin):
    import jax.numpy as jnp

    x = _rand(3, 1, 32, 48, cin)
    ref = J.trunkApply(weights[0], trunk, jnp.asarray(x), numBlocks=BLOCKS)
    with torch.inference_mode():
        got = conv(getattr(weights[1], trunk), torch.from_numpy(x))
    _close(got.numpy(), ref)


def test_upsample_matches_jax(weights):
    """The plain conv + pixel-shuffle form against JAX's deferred sub-pixel
    layout: the same products, summed in another order."""
    import jax.numpy as jnp

    feat = (_rand(4, 2, 16, 24, 64) - 0.5) * 4
    ref = J.upsampleApply(weights[0], jnp.asarray(feat))
    with torch.inference_mode():
        got = conv(weights[1].upsample, torch.from_numpy(feat))
    assert got.shape == (2, 64, 96, 3)
    _close(got.numpy(), ref)


def _frames():
    """22 frames of 48x40: a drifting pattern plus noise, so the flows are
    not zero."""
    rng = np.random.RandomState(5)
    base = rng.rand(64, 64, 3).astype(np.float32)
    return [0.8 * np.roll(base, (i, -i), axis=(0, 1))[:48, :40] + 0.2 * rng.rand(48, 40, 3).astype(np.float32)
            for i in range(22)]


def _runJax(weights):
    import jax.numpy as jnp

    opt = J.VSROpt()
    opt.params, opt.dtype, opt.start = weights[0], jnp.float32, 3
    origTrunk = J.trunkApply
    J.trunkApply = lambda p, prefix, x, numBlocks=BLOCKS: origTrunk(p, prefix, x, BLOCKS)
    try:
        f = J.doVSR(lambda x: None if x is None else [np.asarray(x)], JaxNode({"op": "test"}), opt)
        outs = []
        for fr in _frames():
            outs.extend(f(jnp.asarray(fr)))
        opt.end = -3
        return outs + f(None)
    finally:
        J.trunkApply = origTrunk


def _runPort(weights):
    opt = P.VSROpt()
    opt.model, opt.dtype, opt.start = weights[1], torch.float32, 3
    f = P.doVSR(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    outs = []
    for fr in _frames():
        outs.extend(f(torch.from_numpy(fr)))
    opt.end = -3
    return outs + f(None)


def test_do_vsr_matches_jax(weights):
    """22 frames with the reflection padding video.prepare sets (3 at each
    end, for the keyframe windows): two backward chunks of 20 and 2 frames,
    each from a fresh state, two forward chunks carrying the state across,
    keyframes every 7 frames and at the end of each span (5 EDVR clips),
    and the x4 output cropped from the 64-aligned pad."""
    calls, launches = weights[1].edvr.calls, deformConv2d.launches
    got = _runPort(weights)
    assert weights[1].edvr.calls - calls == 5 and deformConv2d.launches == launches
    ref = _runJax(weights)
    assert len(got) == len(ref) == 22
    for g, r in zip(got, ref):
        assert g.shape == (192, 160, 3)
        _close(g, r)


def test_keyframe_marks(weights):
    """Every 7th frame and the tail of each pop, as JAX's KeyFrameState."""
    for sizes in ((20, 2), (5, 5, 5), (1, 1, 7, 13)):
        a, b = P.KeyFrameState(7), J.KeyFrameState(7)
        for s in sizes:
            np.testing.assert_array_equal(a.pop(s), b.pop(s))
