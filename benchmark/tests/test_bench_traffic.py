"""Each traffic generator repeats for a seed; seeds change the content
and order, never the set of sizes."""

import numpy as np

from benchmark.harness import traffic
from benchmark.harness.spec import BENCH, _json

MIXED = {"kind": "images", "pool": 16, "long_side": [240, 960, 8], "aspects": [[1, 1], [4, 3], [3, 2], [16, 9]],
         "portrait": 0.5, "shape_seed": 5, "sample": 2}


def _small(mix):
    """The mix's shapes at a twentieth of their sides, for a CPU run."""
    return [(max(8, h // 20), max(8, w // 20)) for h, w in traffic.imageShapes(mix)]


def test_images_repeat_for_a_seed(monkeypatch):
    mix = dict(MIXED)
    small = _small(mix)
    monkeypatch.setattr(traffic, "imageShapes", lambda m: small)
    a, oa = traffic.makeImages(mix, 2**33 + 1, "cpu")
    b, ob = traffic.makeImages(mix, 2**33 + 1, "cpu")
    c, oc = traffic.makeImages(mix, 2**33 + 2, "cpu")
    assert oa == ob and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(oa) == sorted(oc) == list(range(16))
    assert [x.shape for x in a] == [x.shape for x in c]  # the same sizes for every seed
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == np.uint8 and x.shape[2] == 3 for x in a)


def test_mixed_shapes_follow_the_mix():
    mix = _json(f"{BENCH}/traffic/small_mixed.json")
    shapes = traffic.imageShapes(mix)
    assert shapes == traffic.imageShapes(dict(mix))
    longs = [max(s) for s in shapes]
    assert all(240 <= l <= 960 and l % 8 == 0 for l in longs)
    ratios = {round(max(s) / min(s), 1) for s in shapes}
    assert ratios <= {1.0, 1.3, 1.5, 1.8}
    assert any(h > w for h, w in shapes) and any(w > h for h, w in shapes)


def test_fixed_sizes_cycle():
    mix = {"kind": "images", "pool": 3, "sizes": [[64, 48], [32, 40]], "sample": 1}
    assert traffic.imageShapes(mix) == [(48, 64), (40, 32), (48, 64)]


def test_clip_repeats_for_a_seed():
    mix = {"kind": "clip", "width": 48, "height": 32, "frames": 5, "max_speed": 3}
    a = traffic.makeClip(mix, 2**40 + 3, "cpu")
    b = traffic.makeClip(mix, 2**40 + 3, "cpu")
    c = traffic.makeClip(mix, 2**40 + 4, "cpu")
    assert a == b and a != c and len(a) == 5
    assert all(len(f) == 48 * 32 * 6 for f in a)
    (vy, vx), (py, px) = traffic.clipMotion(mix, 2**40 + 3)
    assert max(abs(vy), abs(vx), abs(py), abs(px)) <= 3 and vx != 0 and px != 0
    v = np.frombuffer(a[0], np.uint16)
    assert v.max() > 32767  # the 16-bit range is used in full, through the int16 view
