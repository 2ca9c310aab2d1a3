"""The check that decides ``correct`` fails its control and the faults a
cell can have, at a size a CPU test run can hold.

The control is the plain reference in fp8 (the precision below the
configurations' bf16) put in the program's place.  The faults are planted
in the program under a run: an answer altered where it is produced, half
of a batch left out with the mean of the rest in its place, a step that
returns its state unchanged.  (No cell has an exchange between cards.)
The unbroken program, in fp32 on the CPU, passes.
"""

import pytest
import torch

from benchmark.harness.cell import Window, verdict
from benchmark.reference.layers import fp8
from benchmark.tests.helpers import runTiny, tinyCell

IMAGE_CELLS = ("sr_lite4_1080p", "sr_lite4_small_mixed")
VIDEO_CELLS = ("slomo_ifrnet_m_1080p",)


@pytest.mark.parametrize("name", IMAGE_CELLS + VIDEO_CELLS)
def test_control_fails(name, tmp_path):
    cell = tinyCell(name)
    drv = cell.driver().Driver(cell, 2**32 + 9, "cpu", str(tmp_path))
    numbers = drv.check(drv.controlEntries(3, fp8))
    ok, checks = verdict(cell, Window(0.0, 1.0, attempted=1), numbers)
    assert not ok, checks


@pytest.mark.parametrize("name", IMAGE_CELLS + VIDEO_CELLS)
def test_unbroken_program_passes(name, tmp_path):
    ok, checks, _ = runTiny(name, tmp_path)
    assert ok, checks


def _halfBatch(forward):
    """The module's forward with half of its batch (every other entry, so
    that a chunk padded with copies of its last tile loses real ones) left
    out and the mean of the other half's outputs in its place."""

    def f(self, x, *a, **k):
        y = forward(self, x, *a, **k)
        for t in y if isinstance(y, list) else [y]:
            t[1::2] = t[0::2].mean(0, keepdim=True)
        return y

    return f


def _alterImage(call):
    def f(self, x):
        y = call(self, x).clone()
        y[: y.shape[0] // 2, : y.shape[1] // 2] += 0.1  # one corner's tiles wrong by 10 %
        return y

    return f


def _unchangedImage(call):
    def f(self, x):  # the SR step's state returned as it came in, at the output's size
        x = torch.as_tensor(x).float()
        s = int(self.spec.scale)
        return x.repeat_interleave(s, 0).repeat_interleave(s, 1)

    return f


@pytest.mark.parametrize("name", IMAGE_CELLS)
@pytest.mark.parametrize("fault", ("altered", "half_batch", "unchanged"))
def test_image_faults_fail(name, fault, tmp_path, monkeypatch):
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.models.sr import MoeNetLite2

    if fault == "altered":
        monkeypatch.setattr(ModelExec, "__call__", _alterImage(ModelExec.__call__))
    elif fault == "half_batch":
        monkeypatch.setattr(MoeNetLite2, "forward", _halfBatch(MoeNetLite2.forward))
    else:
        monkeypatch.setattr(ModelExec, "__call__", _unchangedImage(ModelExec.__call__))
    ok, checks, _ = runTiny(name, tmp_path)
    assert not ok, checks


def _alterFrame(postOut):
    def f(*args):
        y = postOut(*args).clone()
        y[:, : y.shape[1] // 2, : y.shape[2] // 2] += 0.1  # a quarter of the frame wrong by 10 %
        return y.clamp(0, 1)

    return staticmethod(f)


def _unchangedFrame(postOut):
    def f(pairN, means, embt, decoded):  # the left frame comes back as the interpolated one
        r, k = embt.shape
        left = (pairN[:, 0] + means[:, 0]).float()
        return left.repeat_interleave(k, 0).clamp(0, 1)

    return staticmethod(f)


@pytest.mark.parametrize("name", VIDEO_CELLS)
@pytest.mark.parametrize("fault", ("altered", "half_batch", "unchanged"))
def test_video_faults_fail(name, fault, tmp_path, monkeypatch):
    from moephoto_tpu_torch.models import ifrnet

    if fault == "altered":
        monkeypatch.setattr(ifrnet.IFRNet, "postOut", _alterFrame(ifrnet.IFRNet.postOut))
    elif fault == "half_batch":  # the encoder's chunk of frames
        monkeypatch.setattr(ifrnet.Encoder, "forward", _halfBatch(ifrnet.Encoder.forward))
    else:
        monkeypatch.setattr(ifrnet.IFRNet, "postOut", _unchangedFrame(ifrnet.IFRNet.postOut))
    ok, checks, _ = runTiny(name, tmp_path)
    assert not ok, checks


@pytest.mark.cuda
def test_control_on_the_card(card, tmp_path):
    """The control at the small cell's own size on the card (the full
    readings are taken by ``benchmark/tools/control.py``)."""
    from benchmark.harness import spec

    cell = spec.cell("sr_lite4_small_mixed")
    drv = cell.driver().Driver(cell, 2**31 + 1, card, str(tmp_path))
    numbers = drv.check(drv.controlEntries(2, fp8))
    assert not verdict(cell, Window(0.0, 1.0, attempted=1), numbers)[0], numbers
