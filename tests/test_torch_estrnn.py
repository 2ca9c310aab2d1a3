"""The port's ESTRNN (moephoto_tpu_torch/models/estrnn.py) against the JAX
package's (moephoto_tpu/models/estrnn.py): the layer primitives it adds
(the exact GELU, ``linear``, the stride-2 ConvTranspose2d), the RDBCell,
GSA and the reconstructor, the chunk recurrence with its pooled weights,
GSA + reconstructor with the reflect pad, the whole ``doESTRNN`` stream
and the ``demob`` step through ``cli video``, on ``synthESTRNNParams``
weights (torch layout), which are the JAX ``synthParams`` draws.

Tolerance 2e-6 * max(1, |ref|) elementwise for the modules and stream,
fp32 on the CPU with JAX at ``highest`` precision: the same convolutions
summed in another order (the outputs are of order 0.1, and a difference
of a few fp32 ulps carries through the 60 convs of a recurrence step).
The pooled weights are a mean summed in fp64 here and in fp32 in JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from moephoto_tpu.config import config as jaxConfig
from moephoto_tpu.models import api as JA
from moephoto_tpu.models import estrnn as J
from moephoto_tpu.progress import Node as JaxNode
from moephoto_tpu_torch.config import config
from moephoto_tpu_torch.models import api as PA
from moephoto_tpu_torch.models import estrnn as P
from moephoto_tpu_torch.models.api import conv, fromJaxParams
from moephoto_tpu_torch.progress import Node
from moephoto_tpu_torch.synth import synthESTRNNParams, synthIFRNetParams
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's ESTRNN with the same weights), JAX at
    ``highest`` precision while the module's tests run."""
    import jax.numpy as jnp

    old = JA.getPrecision()
    JA.setPrecision("highest")
    raw = synthESTRNNParams(0)
    model = P.ESTRNN()
    model.load_state_dict({f"{m}.{k}": v for m, sd in raw.items() for k, v in sd.items()}, strict=True)
    yield {k: jnp.asarray(v) for k, v in J.synthParams(0).items()}, model.eval()
    JA.setPrecision(old)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), float(err.max())


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def test_synth_weights_are_the_jax_draws():
    """The checkpoint-layout draws carried through ``fromJaxParams`` (with
    ESTRNN's ConvTranspose predicate) from the JAX package's ``synthParams``
    of the same seed: every key, gap 0, the reconstructor's two transposed
    weights (in, out, k, k) included."""
    raw = synthESTRNNParams(3)
    sd = {f"{m}.{k}": v for m, d in raw.items() for k, v in d.items()}
    back = fromJaxParams({k: np.asarray(v) for k, v in J.synthParams(3).items()}, P.isConvT)
    assert set(back) == set(sd) and len(sd) == len(P.ESTRNN().state_dict())
    for k in sd:
        assert back[k].shape == sd[k].shape and torch.equal(back[k], sd[k]), k
    assert sd["recons.0.weight"].shape == (400, 32, 3, 3)


@pytest.mark.parametrize("h,w", [(5, 7), (6, 4)])
def test_conv_transpose_matches_jax(h, w):
    """The stride-2 ConvTranspose2d (padding 1, output padding 1) against
    JAX's ``convTranspose2d`` on the converted weight: exactly 2h x 2w."""
    import jax.numpy as jnp

    from moephoto_tpu.models.api import convertStateDict

    layer = PA.convTranspose2d(6, 4)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(_rand(1, 6, 4, 3, 3) - 0.5))
        layer.bias.copy_(torch.from_numpy(_rand(2, 4)))
    sd = {f"t.{k}": v.numpy() for k, v in layer.state_dict().items()}
    jp = {k: jnp.asarray(v) for k, v in convertStateDict(sd, lambda k, s: k == "t.weight").items()}
    x = _rand(3, 2, h, w, 6)
    ref = JA.convTranspose2d(jp, "t", jnp.asarray(x), stride=2, padding=1, output_padding=1)
    with torch.no_grad():
        got = conv(layer, torch.from_numpy(x))
    assert got.shape == (2, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_gelu_and_linear_match_jax():
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(4).randn(3, 4, 10).astype(np.float32) * 3
    np.testing.assert_allclose(PA.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)), atol=1e-6, rtol=0)
    lin = PA.linear(10, 5)
    sd = {f"l.{k}": v.detach().numpy() for k, v in lin.state_dict().items()}
    jp = {"l.weight": jnp.asarray(sd["l.weight"].T), "l.bias": jnp.asarray(sd["l.bias"])}
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.linear(jp, "l", jnp.asarray(x))), atol=1e-6, rtol=0)


def test_cell_matches_jax(weights):
    import jax.numpy as jnp

    x, hidden = _rand(5, 1, 48, 40, 3), _rand(6, 1, 12, 10, 16, scale=0.1)
    refH, refHidden = J.cellApply(weights[0], jnp.asarray(x), jnp.asarray(hidden))
    with torch.inference_mode():
        got, gotHidden = weights[1].cell(torch.from_numpy(x), torch.from_numpy(hidden))
    assert got.shape == (1, 12, 10, 80) and gotHidden.shape == (1, 12, 10, 16)
    _close(got, refH)
    _close(gotHidden, refHidden)


def test_gsa_and_reconstructor_match_jax(weights):
    import jax.numpy as jnp

    hs, w = _rand(7, 2, 5, 6, 10, 80, scale=0.3), _rand(8, 2, 5, 80, scale=0.3)
    ref = J.gsaApply(weights[0], jnp.asarray(hs), jnp.asarray(w))
    with torch.inference_mode():
        got = weights[1].fusion(torch.from_numpy(hs), torch.from_numpy(w))
    _close(got, ref)
    x = _rand(9, 2, 6, 10, 400, scale=0.3)
    ref = J.reconsApply(weights[0], jnp.asarray(x))
    with torch.inference_mode():
        got = weights[1].recons(torch.from_numpy(x))
    assert got.shape == (2, 24, 40, 3)
    _close(got, ref)


def test_chunk_recurrence_with_pooled_weights_matches_jax(weights):
    """The recurrence over 6 frames with the pooled GSA weights against
    ``cellScanPoolApply``: features, weights and the carried hidden state."""
    import jax.numpy as jnp

    frames, hidden = _rand(10, 6, 48, 40, 3), _rand(11, 1, 12, 10, 16, scale=0.1)
    ref = J.cellScanPoolApply(weights[0], jnp.asarray(frames), jnp.asarray(hidden))
    with torch.inference_mode():
        got = weights[1].cellScanPool(torch.from_numpy(frames), torch.from_numpy(hidden))
    for g, r, shape in zip(got, ref, ((6, 12, 10, 80), (6, 80), (1, 12, 10, 16))):
        assert g.shape == shape
        _close(g, r)


@pytest.mark.parametrize("h,w", [(12, 10), (40, 33)], ids=["pad_beyond_rows", "one_reflection"])
def test_gsa_recons_matches_jax(weights, h, w):
    """GSA + reconstructor against ``gsaReconsApply`` at feature sizes that are
    no multiple of 32: the reflect pad (beyond the 12 rows' own length, and
    within 40 and 33) and the crop."""
    import jax.numpy as jnp

    hsB, wB = _rand(12, 2, 5, h, w, 80, scale=0.3), _rand(13, 2, 5, 80, scale=0.3)
    ref = J.gsaReconsApply(weights[0], jnp.asarray(hsB), jnp.asarray(wB))
    with torch.inference_mode():
        got = weights[1].gsaRecons(torch.from_numpy(hsB), torch.from_numpy(wB))
    assert got.shape == (2, 4 * h, 4 * w, 3) and got.dtype == torch.float32
    _close(got, ref)


def _frames(n, h=48, w=64):
    rng = np.random.RandomState(0)
    return [rng.rand(h, w, 3).astype(np.float32) for _ in range(n)]


def _runJax(params, n, pad):
    import jax.numpy as jnp

    opt = J.ESTRNNOpt()
    opt.params, opt.dtype, opt.start = params, jnp.float32, pad
    f = J.doESTRNN(lambda x: None if x is None else [np.asarray(x)], JaxNode({"op": "test"}), opt)
    outs = []
    for fr in _frames(n):
        outs.extend(f(jnp.asarray(fr)))
    opt.end = -pad
    return outs + f(None)


def _runPort(model, n, pad):
    opt = P.ESTRNNOpt()
    opt.model, opt.dtype, opt.start = model, torch.float32, pad
    f = P.doESTRNN(lambda x: None if x is None else [x.numpy()], Node({"op": "test"}), opt)
    outs = []
    for fr in _frames(n):
        outs.extend(f(torch.from_numpy(fr)))
    opt.end = -pad
    return outs + f(None)


@pytest.mark.parametrize("n,pad,count", [(10, 0, 6), (11, 2, 11)], ids=["no_padding", "padding"])
def test_do_estrnn_matches_jax(weights, n, pad, count):
    """The stream end to end against JAX's ``doESTRNN``: 10 frames with no
    padding (a 5-frame window: 6 out, over two recurrence chunks of 8 and
    2), and 11 with the reflection padding the video engine sets (2 at each
    end: one frame out per frame in)."""
    got = _runPort(weights[1], n, pad)
    ref = _runJax(weights[0], n, pad)
    assert len(got) == len(ref) == count
    for g, r in zip(got, ref):
        assert g.shape == (48, 64, 3)
        _close(g, r)


# --- the demob step ---------------------------------------------------------

DEMOB = {"op": "demob", "model": "1ms8ms"}
SLOMO = {"op": "slomo", "model": "IFRNet S", "sf": 2}


@pytest.fixture
def video(tmp_path, monkeypatch):
    """Synthetic ESTRNN and IFRNet-S checkpoints in a modelDir both packages
    read, an executable fake ffmpeg, the port on the CPU, JAX at
    ``highest`` precision; configs restored after."""
    (tmp_path / "ESTRNN").mkdir()
    torch.save(synthESTRNNParams(1), str(tmp_path / P.modelPaths["1ms8ms"][len("model/"):]))
    (tmp_path / "IFRNet").mkdir()
    torch.save(synthIFRNetParams("S", 3), str(tmp_path / "IFRNet" / "IFRNet_S_GoPro.pth"))
    ff = tmp_path / "ffmpeg"
    ff.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.join(ROOT, "tools", "fakeffmpeg.py")}" "$@"\n')
    ff.chmod(0o755)
    for cfg in (config, jaxConfig):
        monkeypatch.setattr(cfg, "modelDir", str(tmp_path))
        monkeypatch.setattr(cfg, "ffmpegPath", str(ff))
        monkeypatch.setattr(cfg, "opsPath", str(tmp_path / "ops.json"))
    monkeypatch.setattr(config, "device", "cpu")
    old = JA.getPrecision()
    JA.setPrecision("highest")
    yield tmp_path
    JA.setPrecision(old)


def test_demob_gen_process_builds_and_runs(video, monkeypatch):
    """genProcess with a demob step builds the same progress nodes as JAX's
    and runs 6 16-bit frames through it on the CPU: with no reflection
    padding (the video engine sets it), 2 frames of 16-bit bytes out."""
    from moephoto_tpu.pipeline.steps import genProcess as jaxGenProcess
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.runtime.context import context

    monkeypatch.setattr(context, "root", Node({"op": "test"}), raising=False)  # the video engine's progress root
    steps = lambda: [{"op": "buffer", "bitDepth": 16}, dict(DEMOB), {"op": "output"}]
    flat = lambda nodes: [(n.op, n.load, n.total, flat(n.nodes)) for n in nodes]
    process, nodes = genProcess(steps())
    assert flat(nodes) == flat(jaxGenProcess(steps())[1])
    outs = []
    for i in range(6):
        raw = np.random.RandomState(i).randint(0, 65536, (32, 24, 3)).astype(np.uint16)
        outs.extend(process((raw.tobytes(), 32, 24)) or [])
    outs.extend(process((None, 32, 24)) or [])  # the end of the stream, as the video engine sends it
    outs = [b for b in outs if b]  # the forwarded end-of-stream sentinel is None
    assert len(outs) == 2 and all(len(b) == 32 * 24 * 6 for b in outs)  # no engine padding: a 5-frame window


def _capture(engineModule, store):
    prepare = engineModule.prepare

    def prep(*args):
        p = prepare(*args)
        process = p["process"]

        def record(item):
            bufs = process(item)
            store.extend(b for b in bufs or () if b)
            return bufs

        p["process"] = record
        return p

    return prep


def test_cli_video_demob_slomo_matches_jax_cli(video, monkeypatch):
    """BASELINE config 5 at a tiny size: 6 frames of 64x48 through ``cli
    video`` decode -> ESTRNN 1ms8ms -> IFRNet-S slomo x2 -> encode, in the
    port and in the JAX package: 11 frames each, every 16-bit value within
    1 LSB."""
    from moephoto_tpu import cli as jaxCli
    from moephoto_tpu.video import engine as jaxEngine
    from moephoto_tpu_torch import cli
    from moephoto_tpu_torch.video import engine

    monkeypatch.setenv("FAKEFF_FRAMES", "6")
    monkeypatch.setenv("FAKEFF_SIZE", "64x48")
    outs = {}
    for name, mod, eng in (("port", cli, engine), ("jax", jaxCli, jaxEngine)):
        store = []
        monkeypatch.setattr(eng, "prepare", _capture(eng, store))
        path, frames = mod.runVideo(str(video / "in.mkv"), str(video / f"{name}.mkv"), [dict(DEMOB), dict(SLOMO)])
        with open(path) as fp:
            assert (frames, json.load(fp)) == (6, {"bytes": 11 * 64 * 48 * 6, "s": "64x48"})
        outs[name] = np.stack([np.frombuffer(b, np.uint16) for b in store]).astype(np.int64)
    assert outs["port"].shape == outs["jax"].shape == (11, 64 * 48 * 3)
    assert np.abs(outs["port"] - outs["jax"]).max() <= 1
