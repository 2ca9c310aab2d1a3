"""On-card kernel parity gate.

The counterpart of the JAX package's ``tools/chipparity.py``: every
hand-written CUDA kernel of the port is launched on the card and held
against its plain PyTorch version on the same inputs, which is to the
port what ``interpret=True`` is to a Pallas kernel, the same arithmetic
as ordinary framework ops.  A miscompiled or misindexed kernel that the
CPU tests cannot see (they only reach the plain versions) shows here as a
large error.

Same cases as the JAX gate, drawn from ``RandomState(7)`` in the same
order, under the same keys:

  dcnDensePallas             K3  1x16x128x64, dg 8, bf16, offsets in +-2
  warpBounded                K2  1x24x192x3 bf16, fp32 flow in +-4
  backWarpBounded            K2  the same through ``backWarp``
  fusedUpHeads               K1  M 512, c 48, nUps 1, bf16
  ailutTransformPallas       K5  D 33, 1x32x64 fp32, in range
  ailutTransformPallasT_rel  K4  the same LUT on [-0.4, 1.5], relative to
                                 the largest |plain| (extrapolated outputs
                                 reach far above 1)

:func:`buildCases` makes the inputs as numpy arrays in the JAX package's
layouts and needs no card; :func:`runAll` needs one and raises without.

    python -m moephoto_tpu_torch.tools.chipparity
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

SEED = 7
# Largest |kernel - plain| allowed per key.  Each is the tolerance the
# kernel has against its plain version wherever the port checks it,
# rel * |plain| + abs, taken at the largest |plain| of the case (which the
# seed fixes; the CPU tests hold each case's |plain| under MAGNITUDE):
#   K3 bf16: the sampled values agree bit for bit, the contraction sums in
#     another order and the output rounds once, 2^-7 |plain| + 2^-8
#   K2 bf16: one rounding of a blend of values in [0, 1), 2^-7 + 2^-8
#   K1 bf16: a stage value near a rounding boundary may round the other
#     way, 2^-6 |plain| + 2^-6
#   K5, K4 fp32: every operation rounded where the plain version rounds it;
#     bit-equal is expected, 1e-5 allows for nothing but a changed compiler
MAGNITUDE = {"dcnDensePallas": 4.0, "warpBounded": 1.0, "backWarpBounded": 1.0, "fusedUpHeads": 1.0,
             "ailutTransformPallas": 1.0}
TOLERANCES = {
    "dcnDensePallas": 2.0**-7 * MAGNITUDE["dcnDensePallas"] + 2.0**-8,
    "warpBounded": 2.0**-7 + 2.0**-8,
    "backWarpBounded": 2.0**-7 + 2.0**-8,
    "fusedUpHeads": 2.0**-6 * MAGNITUDE["fusedUpHeads"] + 2.0**-6,
    "ailutTransformPallas": 1e-5,
    "ailutTransformPallasT_rel": 1e-5,
}
_BF16, _F32 = "bfloat16", "float32"


def buildCases(seed: int = SEED) -> Dict[str, dict]:
    """The gate's inputs: ``{key: {"arrays": {name: fp32 ndarray},
    "dtypes": {name: working type}, ...}}`` in the JAX package's layouts
    (DCN offsets (B, H, W, dg, 9, 2), weight HWIO; lite parameters HWIO
    under the checkpoint's keys)."""
    from moephoto_tpu_torch.synth import synthLite2Params

    rng = np.random.RandomState(seed)
    f = lambda a: a.astype(np.float32)
    cases: Dict[str, dict] = {}

    B, H, W, C, dg = 1, 16, 128, 64, 8
    arrays = {"x": f(rng.randn(B, H, W, C))}
    arrays["offset"] = f(rng.rand(B, H, W, dg, 9, 2) * 4 - 2)
    arrays["mask"] = f(rng.rand(B, H, W, dg, 9))
    arrays["weight"] = f(rng.randn(3, 3, C, C)) * 0.05
    arrays["bias"] = f(rng.randn(C)) * 0.01
    cases["dcnDensePallas"] = dict(arrays=arrays, dtypes=dict.fromkeys(arrays, _BF16), dg=dg, margin=3)

    arrays = {"img": f(rng.rand(1, 24, 192, 3)), "flow": f(rng.rand(1, 24, 192, 2) * 8 - 4)}
    cases["warpBounded"] = dict(arrays=arrays, dtypes={"img": _BF16, "flow": _F32})
    cases["backWarpBounded"] = cases["warpBounded"]

    M, c = 512, 48
    arrays = {"res": f(rng.randn(M, c)) * 0.2, "im": f(rng.randn(M, c)) * 0.2}
    params = {k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.ndim == 4 else v.numpy()
              for k, v in synthLite2Params(2, seed=3).items()}
    cases["fusedUpHeads"] = dict(arrays=arrays, dtypes=dict.fromkeys(arrays, _BF16), params=params, nUps=1)

    D = 33
    img = f(rng.rand(1, 32, 64, 3))
    lut = f(rng.rand(1, 3, D, D, D))
    iv = f(rng.rand(1, 3, D - 1))
    iv = iv / iv.sum(-1, keepdims=True)
    vertices = np.pad(np.cumsum(iv, -1), ((0, 0), (0, 0), (1, 0)))
    f32 = dict.fromkeys(("img", "lut", "vertices"), _F32)
    cases["ailutTransformPallas"] = dict(arrays={"img": img, "lut": lut, "vertices": vertices}, dtypes=f32)
    imgX = f(rng.rand(1, 32, 64, 3) * 1.9 - 0.4)
    cases["ailutTransformPallasT_rel"] = dict(arrays={"img": imgX, "lut": lut, "vertices": vertices}, dtypes=f32)
    return cases


def portCalls(key: str, case: dict, device) -> Tuple[Callable, Callable, Callable]:
    """For one case, with its tensors on ``device`` in their working types:
    (the wrapper's call, the plain version's call, the wrapper itself,
    whose ``launches`` counts)."""
    from moephoto_tpu_torch.models.api import fromJaxParams
    from moephoto_tpu_torch.ops import deform, fusedup, lut, warp

    t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device, getattr(torch, case["dtypes"][k]))
         for k, a in case["arrays"].items()}
    if key == "dcnDensePallas":
        B, H, W, _ = t["x"].shape
        args = (t["x"], t["offset"].reshape(B, H, W, -1), t["mask"].reshape(B, H, W, -1),
                t["weight"].permute(3, 2, 0, 1).contiguous(), t["bias"], case["dg"])
        return (lambda: deform.deformConv2d(*args)), (lambda: deform.deformConv2dPlain(*args)), deform.deformConv2d
    if key == "warpBounded":
        return (lambda: warp.warp(t["img"], t["flow"])), (lambda: warp.warpPlain(t["img"], t["flow"])), warp.warp
    if key == "backWarpBounded":
        folded = lambda: warp.warpPlain(t["img"], warp.backWarpFlow(t["flow"]))
        return (lambda: warp.backWarp(t["img"], t["flow"])), folded, warp.warp
    if key == "fusedUpHeads":
        params = {k: v.to(device, torch.bfloat16) for k, v in fromJaxParams(case["params"]).items()}
        args = (params, t["res"], t["im"], case["nUps"])
        return ((lambda: fusedup.fusedUpHeads(*args)), (lambda: fusedup.fusedUpHeadsPlain(*args)),
                fusedup.fusedUpHeads)
    args = (t["img"], t["lut"], t["vertices"])
    if key == "ailutTransformPallas":
        return ((lambda: lut.ailutTransformClamped(*args)), (lambda: lut.ailutTransformClampedPlain(*args)),
                lut.ailutTransformClamped)
    if key == "ailutTransformPallasT_rel":
        return (lambda: lut.ailutTransform(*args)), (lambda: lut.ailutTransformPlain(*args)), lut.ailutTransform
    raise KeyError(key)


def measure(key: str, got, want) -> float:
    """The gate's number for a case: the largest |got - want|, for a
    ``_rel`` key over the largest |want|; NaN when either holds one."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    err = float(np.max(np.abs(got - want)))
    return err / float(np.max(np.abs(want))) if key.endswith("_rel") else err


def runAll() -> Dict[str, float]:
    """{key: largest |kernel - plain|} on the card; every case must
    launch its kernel exactly once."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel parity gate needs a CUDA device")
    device = torch.device("cuda")
    out = {}
    for key, case in buildCases().items():
        kernel, plain, wrapper = portCalls(key, case, device)
        before = wrapper.launches
        got = kernel()
        if wrapper.launches != before + 1:
            raise RuntimeError(f"{key}: {wrapper.launches - before} kernel launches, want 1")
        want = plain()
        torch.cuda.synchronize()
        out[key] = measure(key, got.float().cpu().numpy(), want.float().cpu().numpy())
    return out


def assertAll(results: Dict[str, float], tol: Dict[str, float] = TOLERANCES) -> None:
    """Raise unless every result is within its key's tolerance (a NaN
    is not)."""
    bad = {k: v for k, v in results.items() if not (v <= tol[k])}
    if bad:
        raise AssertionError(f"on-card kernel parity FAILED: {bad} (tolerances {({k: tol[k] for k in bad})})")


if __name__ == "__main__":
    r = runAll()
    print(r)
    assertAll(r)
    print("all kernels match their plain versions on the card")
