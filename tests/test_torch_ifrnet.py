"""The port's IFRNet (moephoto_tpu_torch/models/ifrnet.py) against the JAX
package's (moephoto_tpu/models/ifrnet.py), on IFRNet-S weights from JAX
``ifrnet.synthParams`` carried into torch layout by ``fromJaxParams``.

``synthParams`` draws its convs at half the 1/sqrt(fan-in) scale: through
eight layers the features are then set by the biases alone, every two
frames have a cosine similarity above 0.9999 and the flows stay under a
third of a pixel.  The tests scale every conv weight by 3, so features
depend on the frames (the deduper sees a duplicate at 1.0 and scene cuts
near 0.55) and flows reach up to 19 px.

Tolerance 5e-5 * max(1, |ref|) elementwise, fp32 on the CPU with JAX at
``highest`` precision: both compute the same convolutions and warps, in
sums of another order, and a warp turns a coordinate that differs in
the last bits into a feature difference of that size times the local
gradient, through four levels (largest gap seen 2.6e-5 relative, in the
decoder).  The JAX warps run through ``warpXLAExact``, as the JAX
package runs them on the CPU.
"""

import numpy as np
import pytest
import torch

from moephoto_tpu.models import ifrnet as J
from moephoto_tpu.progress import Node as JaxNode
from moephoto_tpu_torch.models import ifrnet as P
from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.progress import Node
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

GAIN = 3.0
TOL = 5e-5
LOW, HIGH = 0.58, 0.993  # deduper thresholds between this clip's similarities
CHS, SIDE = J.Channels["S"], J.SideChannels["S"]


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the port's IFRNet-S with the same weights)."""
    jp = {k: np.asarray(v) * (GAIN if np.asarray(v).ndim == 4 else 1) for k, v in J.synthParams(0).items()}
    model = P.IFRNet("S")
    model.load_state_dict(fromJaxParams(jp, P.isConvT), strict=True)
    return jp, model.eval()


def _jp(weights):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in weights[0].items()}


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(ref))), float(err.max())


def _frames():
    """6 frames of 48x40: a duplicate (2 = 1) and an inverted frame (4)."""
    rng = np.random.RandomState(1)
    base = [rng.rand(48, 40, 3).astype(np.float32) for _ in range(5)]
    return [base[0], base[1], base[1], base[2], 1 - base[3], base[4]]


def test_encoder_matches_jax(weights):
    import jax.numpy as jnp

    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = J.encoderApply(_jp(weights), CHS, jnp.asarray(x))
    with torch.inference_mode():
        got = weights[1].encoder(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 4, 4, 72), (2, 8, 8, 54), (2, 16, 16, 36), (2, 32, 32, 24)]
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


@pytest.mark.parametrize("ensemble", [0, 3])
def test_decoder_matches_jax(weights, ensemble):
    """decoderApply for one pair at two times, 64x64: both TTA groups run
    at ensemble 3 (transforms 0, 1 and 2)."""
    import jax.numpy as jnp

    jp = _jp(weights)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    feats = J.encoderApply(jp, CHS, jnp.asarray(x))
    embt = np.array([0.25, 0.75], np.float32)
    ref = J.decoderApply(jp, CHS, SIDE, feats, jnp.asarray(embt), ensemble=ensemble)
    with torch.inference_mode():
        got = weights[1].decode([torch.from_numpy(np.array(f))[None] for f in feats],
                                torch.from_numpy(embt)[None], ensemble)
    assert got.shape == (2, 64, 64, 8)
    assert float(np.abs(np.asarray(ref)[..., :4]).max()) > 1  # flows of more than a pixel
    _close(got.numpy(), ref)


def test_post_out_matches_jax(weights):
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    pair = rng.rand(2, 32, 48, 3).astype(np.float32)
    means = pair.mean(axis=(1, 2, 3), keepdims=True)
    pairN = pair - means
    embt = np.array([0.3, 0.6], np.float32)
    decoded = (rng.randn(2, 32, 48, 8) * [3, 3, 3, 3, 1, 0.1, 0.1, 0.1]).astype(np.float32)
    ref = J.postOutApply(None, jnp.asarray(pair), jnp.asarray(pairN), jnp.asarray(means), jnp.asarray(embt),
                         jnp.asarray(decoded))
    got = P.IFRNet.postOut(torch.from_numpy(pairN)[None], torch.from_numpy(means)[None],
                           torch.from_numpy(embt)[None], torch.from_numpy(decoded))
    _close(got.numpy(), ref)


def test_batched_pairs_equal_pair_by_pair(weights):
    """decode and postOut take r pairs as one batch and give what the
    chunk call (pair by pair) gives."""
    model = weights[1]
    x = torch.from_numpy(np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32))
    t = torch.tensor([[0.5], [0.5]])
    with torch.inference_mode():
        m, inpN, feats = model.encodeFull(x)
        pairs = lambda a: torch.stack([a[:2], a[1:]], 1)  # (2, 2, ...): pairs (0, 1) and (1, 2)
        each = model.decodePost([pairs(f) for f in feats], t, pairs(inpN), pairs(m))
        batched = model.postOut(pairs(inpN), pairs(m), t, model.decode([pairs(f) for f in feats], t))
    assert each.shape == (2, 1, 32, 32, 3)
    _close(batched.numpy(), each.reshape(2, 32, 32, 3).numpy())


def _runJax(weights, sf, ensemble, dedupe):
    import jax.numpy as jnp

    opt = J.IFRNetOpt()
    opt.params, opt.dtype, opt.chs, opt.side = _jp(weights), jnp.float32, CHS, SIDE
    opt.sf, opt.ensemble, opt.dedupe, opt.dedupeLow, opt.dedupeHigh = sf, ensemble, dedupe, LOW, HIGH
    f = J.doSlomo(lambda x: None if x is None else [np.asarray(x)], JaxNode({"op": "test"}), opt)
    outs = []
    for fr in _frames():
        outs.extend(f(jnp.asarray(fr)))
    return outs + f(None)


def _runPort(weights, sf, ensemble, dedupe):
    opt = P.IFRNetOpt()
    opt.model, opt.dtype = weights[1], torch.float32
    opt.sf, opt.ensemble, opt.dedupe, opt.dedupeLow, opt.dedupeHigh = sf, ensemble, dedupe, LOW, HIGH
    f = P.doSlomo(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    outs = []
    for fr in _frames():
        outs.extend(f(torch.from_numpy(fr)))
    return outs + f(None)


def test_clip_has_a_duplicate_and_scene_cuts(weights):
    """The deduper's similarities on this clip fall clearly on either
    side of its thresholds: a duplicate (1 -> 2), two cuts into and out of
    the inverted frame, the rest between."""
    pad = lambda f: P.alignPad(torch.from_numpy(f), 16)[0](torch.from_numpy(f))
    with torch.inference_mode():
        _, _, feats = weights[1].encodeFull(torch.stack([pad(f) for f in _frames()]))
    l0 = feats[0].reshape(6, -1)
    sims = [float(l0[i] @ l0[i + 1] / l0[i].norm() / l0[i + 1].norm()) for i in range(5)]
    assert sims[1] > HIGH
    assert sims[3] < LOW - 0.01 and sims[4] < LOW - 0.01, sims
    assert LOW + 0.01 < sims[0] < HIGH and LOW + 0.01 < sims[2] < HIGH, sims


@pytest.mark.parametrize("sf,ensemble,dedupe,count", [
    (2.0, 0, False, 11),  # uniform k = 1: one chunk call
    (2.5, 0, False, 13),  # k alternates 1, 2: pair by pair
    (2.0, 3, False, 11),  # flow TTA, both groups
    (2.0, 0, True, 11),  # the duplicate is interpolated over, each cut repeats a frame
], ids=["sf2", "sf2.5", "ensemble3", "dedupe"])
def test_do_slomo_matches_jax(weights, sf, ensemble, dedupe, count):
    ref = _runJax(weights, sf, ensemble, dedupe)
    got = _runPort(weights, sf, ensemble, dedupe)
    assert len(got) == len(ref) == count
    for g, r in zip(got, ref):
        assert g.shape == (48, 40, 3)
        _close(g, r)
