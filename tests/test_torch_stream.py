"""The port's stream runtime (moephoto_tpu_torch/engine/stream.py) against
the JAX package's (moephoto_tpu/engine/stream.py): the same scenarios on
the same integer-tagged frames must emit identical sequences.

A frame is a 2-vector filled with its tag; each scenario runs once with
each package's module and its array type, and returns the tags of what
came out."""

import numpy as np
import pytest
import torch

from moephoto_tpu.engine import stream as jaxStream
from moephoto_tpu_torch.engine import stream as portStream
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)


def _jaxBatch(tags):
    import jax.numpy as jnp

    return jnp.asarray(np.repeat(np.asarray(tags, np.float32)[:, None], 2, 1))


def _portBatch(tags):
    return torch.from_numpy(np.repeat(np.asarray(tags, np.float32)[:, None], 2, 1))


KITS = {"jax": (jaxStream, _jaxBatch), "port": (portStream, _portBatch)}


def tags(x):
    if x is None:
        return None
    if isinstance(x, list):
        return [tags(t) for t in x]
    return np.asarray(x)[..., 0].astype(int).tolist()


def windows(S, batch):
    """Windows over row refs and loose items, reserve, end padding."""
    s = S.Stream(window=3, reserve=2)
    out = []
    s.put(batch([0, 1, 2, 3]))
    s.put([batch([4])[0]])
    out.append(tags(s.pop(2)))
    s.put(batch([5, 6]))
    out.append(tags(s.pop(8)))  # fewer than 8 windows: nothing
    out.append(tags(s.pop(1)))
    s.setPadding(-2)
    s.applyEndPad()
    out.append(s.avail())
    out.append(tags(s.pop(s.avail())))
    return out


def startPadding(S, batch):
    """Reflection padding at the start: nothing is available until the
    padding has been applied, then the reflected frames lead."""
    s = S.Stream(window=3)
    s.setPadding(2)
    avail = []
    for t in range(5):
        s.put([batch([t])[0]])
        avail.append(s.avail())
    return [avail, tags(s.pop(s.avail()))]


def popItems(S, batch):
    """popItems on a windowed tensor stream: row refs into one window
    tensor, restacked losslessly; on a list stream, the items."""
    s = S.Stream(window=2)
    s.put(batch([0, 1, 2, 3, 4]))
    items = s.popItems(3)
    same = all(it.ref is items[0].ref for it in items)
    t = S.Stream(tensor=False, batchFunc=lambda x: x)
    t.put(["a", "b", "c"])
    return [same, tags(S.stackBatch(items)), t.popItems(2), t.pop(1)]


class Hold:
    """Holds back its last item until a later batch or the flush call."""

    def __init__(self):
        self.held = None

    def __call__(self, items, last=None):
        if items is None:  # the flushOnce call
            held, self.held = self.held, None
            return None if held is None else [held]
        out = [] if self.held is None else [self.held]
        out += items[:-1]
        self.held = items[-1]
        return out or None


def graph(S, batch):
    """A tee into a window-2 branch (chunks of 3, summed per window, then
    a flushOnce stage) and a plain branch (chunks of 2), flushed by
    depth; frames arrive one by one and in a batch."""
    g = S.StreamGraph()
    src, a, b = S.Stream(), S.Stream(window=2), S.Stream()
    mid = S.Stream(tensor=False, batchFunc=lambda x: x)
    outA, outB = S.Stream(store=False), S.Stream(store=False)
    outA.sink, outB.sink = [], []
    g.tee(src, [a, b])
    g.stage(lambda w, last=None: [w[i].sum(0) for i in range(w.shape[0])], [a], [mid], size=3)
    g.stage(Hold(), [mid], [outA], flushOnce=True)
    g.stage(lambda x, last=None: [x[i] * 10 for i in range(x.shape[0])], [b], [outB], size=2)
    seen = []
    for t in range(4):
        src.put([batch([t])[0]])
        g.run()
        seen.append((len(outA.sink), len(outB.sink)))
    src.put(batch([4, 5, 6]))
    g.run()
    seen.append((len(outA.sink), len(outB.sink)))
    g.run(last=True)
    return [seen, tags(outA.sink), tags(outB.sink)]


def stacking(S, batch):
    """stackBatch and stackRuns merge runs, alias full coverage, zero-fill
    Nones and pad the tail."""
    a, b = batch([0, 1, 2, 3]), batch([10, 11])
    R = S.RowRef
    mixed = S.stackBatch([R(a, 1), R(a, 2), b[0], R(b, 0), R(b, 1), R(a, 0)])
    runs = S.stackRuns([(a, 1), (a, 2), None, None, (b, 0)], 5, 7, (2,))
    return [tags(mixed), S.stackBatch([R(a, i) for i in range(4)]) is a,
            tags(runs), S.stackRuns([(a, i) for i in range(4)], 4, 4, (2,)) is a,
            tags(S.stackRuns([(a, 2), (a, 0)], 2, 2, (2,)))]


@pytest.mark.parametrize("scenario", [windows, startPadding, popItems, graph, stacking],
                         ids=lambda f: f.__name__)
def test_port_emits_what_jax_emits(scenario):
    got = scenario(*KITS["port"])
    ref = scenario(*KITS["jax"])
    assert got == ref


def test_put_keeps_tensor_batches_as_row_refs():
    """A torch batch is stored as row refs (the JAX package tests jnp and
    numpy arrays), and a full-coverage pop returns the tensor itself."""
    a = _portBatch([0, 1, 2])
    s = portStream.Stream()
    s.put(a)
    assert all(isinstance(t, portStream.RowRef) for t in s.state)
    assert s.pop(3) is a


def test_stack_runs_zeros_follow_the_sources_device_and_dtype():
    a = _portBatch([1, 2]).to(torch.bfloat16)
    got = portStream.stackRuns([(a, 0), None], 2, 3, (2,), dtype=torch.float32)
    assert got.dtype == torch.float32 and got.device == a.device
    assert tags(got) == [1, 0, 0]
