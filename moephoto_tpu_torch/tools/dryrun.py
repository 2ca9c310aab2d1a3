"""Multi-device dry run: every sharded path of the port once, at small
shapes, on a mesh of n devices.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
one sharded SGD step of MoeNet_lite2 x2 over dp x sp, one sharded tiled
forward, and the row-sharded stages of IconVSR, ESTRNN and IFRNet-S, with
seeded random weights (``synth.py``).  It prints the JAX line::

    dryrun_multichip(n): loss=... infer=... video=... estrnn=... ifrnet=...

The line ends with the mesh's devices (``devices=cuda:0*8``).  The mesh
takes the CUDA cards: ``cuda:0`` to ``cuda:n-1``, or ``cuda:0`` x n (every
shard on one card) where there are fewer than n; without a card it stops.
The CPU is taken only when asked for::

    python -m moephoto_tpu_torch.tools.dryrun [n]                  # the cards
    python -m moephoto_tpu_torch.tools.dryrun [n] --backend cpu    # cpu x n

or ``dryrunMultichip(n, ["cpu"] * n)``.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch


def cardsFor(n: int) -> list:
    """n mesh entries on the CUDA cards: one card each where there are n,
    else ``cuda:0`` x n.  Raises without a card: the dry run never moves to
    the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass devices=['cpu'] * n (--backend cpu) to run on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= n else 0) for i in range(n)]


def describe(devices) -> str:
    """``cuda:0*8`` for one device repeated, else the devices by commas."""
    names = [str(d) for d in devices]
    return f"{names[0]}*{len(names)}" if len(set(names)) == 1 else ",".join(names)


def dryrunMultichip(n: int, devices: Optional[Sequence] = None) -> str:
    """Run the sharded paths on ``n`` devices (:func:`cardsFor` when none
    are given) and print, and return, the summary line."""
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.models import estrnn as E
    from moephoto_tpu_torch.models import iconvsr as V
    from moephoto_tpu_torch.models import ifrnet as I
    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.parallel import mesh as M
    from moephoto_tpu_torch.parallel.sharded import RowShards, makeShardedTrainStep, shardedTiledForward
    from moephoto_tpu_torch.synth import (synthESTRNNParams, synthIconVSRParams, synthIFRNetParams,
                                          synthLite2Params)

    devices = [torch.device(d) for d in devices] if devices is not None else cardsFor(n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n}")
    home = devices[0]
    whole = lambda v: v.gather() if isinstance(v, RowShards) else v  # noqa: E731

    dp = 2 if n % 2 == 0 else 1
    sp = n // dp
    mesh = M.makeMesh([dp, sp], devices=devices)
    params = synthLite2Params(2)
    lite = MoeNetLite2(2, fused=False)
    step = makeShardedTrainStep(lite, mesh, halo=8, scale=2, lr=1e-4)
    B, H, W = dp * 2, sp * 32, 64
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, H, W, 1).astype(np.float32)).to(home)
    y = torch.from_numpy(rng.rand(B, H * 2, W * 2, 1).astype(np.float32)).to(home)
    _, loss = step(params, x, y)

    # one sharded inference of the same model on the mesh
    lite.load_state_dict(params)
    replicas = {d: M.replicaOn(lite, d).eval() for d in set(devices)}
    fwd = shardedTiledForward(lambda v: replicas[v.device](v), mesh, halo=4, scale=2)
    xi = torch.from_numpy(rng.rand(dp * 2, sp * 24, 32, 1).astype(np.float32)).to(home)
    with torch.inference_mode():
        out = fwd(xi)

    # the row-sharded video stages on the flattened [n] row mesh
    oldDevice = config.device
    config.device = str(home)
    M.installMesh(M.makeMesh([n], devices=devices))
    try:
        vr = np.random.RandomState(2)
        r = lambda *s: torch.from_numpy(vr.rand(*s).astype(np.float32)).to(home)  # noqa: E731

        vsr = V.IconVSR()
        vsr.load_state_dict({f"{m}.{k}": v for m, d in synthIconVSRParams(0).items() for k, v in d.items()})
        vsr.eval().to(home)
        T, vH, vW = 3, math.lcm(64, n), 64
        frames, kfStack = r(T, vH, vW, 3), r(1, vH, vW, V.NumFeat) * 0.1
        pairs = r(T, 2, vH, vW, 3)
        kfs, warps = [kfStack, None, None], [False, True, True]
        featProp = torch.zeros((1, vH, vW, V.NumFeat), device=home)
        with torch.inference_mode():
            bwd = vsr.backwardScan(frames, V.toFloat(vsr.spynet(pairs)), warps, kfs)
            feats, _ = vsr.forwardScan(featProp, frames, [V.rowsOf(bwd, t) for t in range(T)],
                                       V.toFloat(vsr.spynet(pairs.flip(1))), warps, kfs)
            vout = whole(vsr.upsampleChunk(frames, feats))

        est = E.ESTRNN()
        est.load_state_dict({f"{m}.{k}": v for m, d in synthESTRNNParams(0).items() for k, v in d.items()})
        est.eval().to(home)
        eH = max(64, 4 * n)
        ef = r(6, eH, 64, 3)
        eh = torch.zeros((1, eH >> E.DS_ratio, 64 >> E.DS_ratio, E.NumFeat), device=home)
        with torch.inference_mode():
            hs, wArr, _ = est.cellScanPool(ef, eh)
            hs = whole(hs)
            eout = whole(est.gsaRecons(torch.stack([hs[0:5], hs[1:6]]), torch.stack([wArr[0:5], wArr[1:6]])))

        ifr = I.IFRNet("S")
        ifr.load_state_dict({f"{m}.{k}": v for m, d in synthIFRNetParams("S").items() for k, v in d.items()})
        ifr.eval().to(home)
        im3 = r(3, eH, 64, 3)
        with torch.inference_mode():
            mean, inpN, ifeats = ifr.encodeFull(im3)
            ifeats = [whole(f) for f in ifeats]
            fpair = [torch.stack([torch.stack([lv[0], lv[1]]), torch.stack([lv[1], lv[2]])]) for lv in ifeats]
            iout = whole(ifr.decodePost(fpair, torch.full((2, 1), 0.5, device=home),
                                        torch.stack([inpN[0:2], inpN[1:3]]), torch.stack([mean[0:2], mean[1:3]])))
    finally:
        M.installMesh(None)
        config.device = oldDevice
    line = (f"dryrun_multichip({n}): loss={float(loss):.5f} infer={tuple(out.shape)} video={tuple(vout.shape)} "
            f"estrnn={tuple(eout.shape)} ifrnet={tuple(iout.shape)} devices={describe(devices)}")
    print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="mesh size (default 8)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"), help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return dryrunMultichip(args.n, ["cpu"] * args.n if args.backend == "cpu" else None)


if __name__ == "__main__":
    main()
