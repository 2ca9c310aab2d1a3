"""Fine-tune a zoo SR model on an image folder, on the card.

Self-supervised SR fine-tuning: HR patches sampled from the user's
images, box-downscaled to LR (or noised, for scale-1 denoise models), and
L1(model(LR), HR) minimised by Adam over a dp (batch) x sp (rows, halo
exchange) mesh (``parallel/sharded.makeOptaxTrainStep``), with
``torch.save`` checkpoints.  The counterpart of the JAX package's
``tools/train.py``: the same flags, lines and patches for a seed.

Usage:
  python -m moephoto_tpu_torch.tools.train --data 'photos/*.png' --model lite \\
      --scale 2 --steps 2000 --batch 8 --patch 64 --lr 1e-4 --out ft
  # resume:
  python -m moephoto_tpu_torch.tools.train ... --out ft --resume

Runs on the CUDA cards (mesh [cards, 1] unless --mesh dp,sp says), or on
the CPU with --backend cpu (a mesh of dp x sp CPU entries, the counterpart
of the JAX package's virtual host devices); without a card and without
--backend cpu it stops.  ``main`` returns the fp32 state dict, which the
inference module of the same model loads with ``strict=True``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def buildModel(name: str, scale: int, dtype=torch.float32, fromScratch: bool = False):
    """(model, params, halo, scale, channels) for a trainable model: the
    module runs the plain path (no hand-written kernel: training needs a
    backward), ``params`` its state dict in ``dtype``.

    ``lite`` needs no checkpoint: MoeNet_lite2 on ``synth.synthLite2Params``,
    the JAX package's random draws for seed 0.  Any other name is looked up
    in the three registries (``lite2``/``a2``/``lite5``/``gan4``/...) and
    fine-tunes its checkpoint; with ``fromScratch``, random weights of the
    checkpoint's shapes."""
    from moephoto_tpu_torch.models.sr import MoeNetLite2

    if name == "lite":
        from moephoto_tpu_torch.synth import synthLite2Params

        model = MoeNetLite2(scale, fused=False)
        params = {k: v.to(dtype) for k, v in synthLite2Params(scale, 0).items()}
        return model, params, 8, scale, 1

    from moephoto_tpu_torch.models.api import loadTorchWeights
    from moephoto_tpu_torch.pipeline import registry as R

    entry = next((reg[name] for reg in (R.SR_REGISTRY, R.DN_REGISTRY, R.DEHAZE_REGISTRY) if name in reg), None)
    if entry is None:
        raise SystemExit(f"unknown --model {name} (try lite, lite2, a2, lite5, ...)")
    path = R.modelPath(entry["path"])
    if not os.path.exists(path):
        raise SystemExit(f"checkpoint {entry['path']} not available for --model {name}")
    model = getattr(R._lazyImport(entry["family"]), entry["fn"])()
    if hasattr(model, "fused"):
        model.fused = False
    params = loadTorchWeights(path, entry["convT"])
    if fromScratch:
        rng = np.random.RandomState(0)
        params = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.05) if v.ndim else v
                  for k, v in params.items()}
    params = {k: v.to(dtype) for k, v in params.items()}
    spec = entry["spec"]
    return model, params, max(8, int(spec.pad)), int(spec.scale), (1 if entry["channelSplit"] else 3)


class PatchSampler:
    """Random HR/LR patch batches from an image folder, the JAX package's
    draws for a seed.

    channels=1 samples luma (the channel-split families are single-channel
    by design); channels=3 samples RGB.  scale>1: LR = box-downscaled HR
    (SR fine-tuning); scale==1: LR = HR + Gaussian noise of ``sigma``
    (denoise fine-tuning)."""

    def __init__(self, paths, patch: int, scale: int, seed: int = 0, channels: int = 1, sigma: float = 0.03):
        from PIL import Image

        self.rng = np.random.RandomState(seed)
        self.patch = patch
        self.scale = scale
        self.channels = channels
        self.sigma = sigma
        self.imgs = []
        for p in paths:
            mode = "L" if channels == 1 else "RGB"
            with Image.open(p) as img:
                im = np.asarray(img.convert(mode), np.float32) / 255.0
            if channels == 1:
                im = im[..., None]
            hp = patch * scale
            if im.shape[0] >= hp and im.shape[1] >= hp:
                self.imgs.append(im)
        if not self.imgs:
            raise SystemExit(f"no images of at least {patch * scale}px among {len(paths)} inputs")

    def batch(self, n: int):
        """(n, p, p, C) LR/noisy, (n, p*s, p*s, C) HR, numpy fp32."""
        s, p, c = self.scale, self.patch, self.channels
        hp = p * s
        lrs, hrs = [], []
        for _ in range(n):
            im = self.imgs[self.rng.randint(len(self.imgs))]
            y = self.rng.randint(im.shape[0] - hp + 1)
            x = self.rng.randint(im.shape[1] - hp + 1)
            hr = im[y : y + hp, x : x + hp]
            if s > 1:
                lr = hr.reshape(p, s, p, s, c).mean((1, 3))  # area (box) downscale
            else:
                lr = np.clip(hr + self.rng.randn(*hr.shape).astype(np.float32) * self.sigma, 0.0, 1.0)
            lrs.append(lr)
            hrs.append(hr)
        return np.stack(lrs).astype(np.float32), np.stack(hrs).astype(np.float32)


def evalPSNR(model, params, sampler: PatchSampler, n: int = 16, seed: int = 123, device="cpu") -> float:
    """Held-out PSNR of ``model`` on ``params`` against HR over ``n``
    patches, on ``device`` in true fp32 (the quality number a fine-tuning
    user cares about)."""
    from moephoto_tpu_torch.models.api import fullFp32

    sampler.rng = np.random.RandomState(seed)  # fixed eval patches
    x, y = sampler.batch(n)
    onDevice = {k: v.detach().to(device, torch.float32) for k, v in params.items()}
    with torch.no_grad(), fullFp32():
        pred = torch.func.functional_call(model, onDevice, (torch.from_numpy(x).to(device),))
    mse = float(np.mean((np.clip(pred.float().cpu().numpy(), 0, 1) - np.clip(y, 0, 1)) ** 2))
    return 10 * float(np.log10(1.0 / max(mse, 1e-12)))


def cards(backend: str):
    """The CUDA cards a mesh may take, or None for ``--backend cpu`` (a mesh
    of CPU entries).  Without a card the default stops: training never
    moves to the CPU unasked."""
    if backend == "cpu":
        return None
    if backend not in ("", "cuda"):
        raise SystemExit(f"unknown --backend {backend} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --backend cpu to train on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="image glob for HR patches")
    ap.add_argument("--model", default="lite")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8, help="global batch (divisible by dp)")
    ap.add_argument("--patch", type=int, default=64, help="LR patch size (rows divisible by sp)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--mesh", default="", help="dp,sp (default: every card on dp; [1, 1] on the CPU)")
    ap.add_argument("--backend", default="", help="cuda (default) or cpu")
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fromScratch", action="store_true", help="random init instead of the registry checkpoint")
    ap.add_argument("--saveEvery", type=int, default=200)
    ap.add_argument("--sigma", type=float, default=0.03, help="noise level for scale-1 (denoise) fine-tuning")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--computeDtype", default="fp32", choices=("fp32", "bf16"),
                    help="bf16 = mixed precision: bf16 forward/backward, fp32 master params + optimizer")
    ap.add_argument("--holdout", default="", help="image glob for held-out PSNR eval (printed before and after)")
    args = ap.parse_args(argv)

    from moephoto_tpu_torch.parallel.mesh import makeMesh
    from moephoto_tpu_torch.parallel.sharded import makeOptaxTrainStep

    avail = cards(args.backend)
    if args.mesh:
        dp, sp = (int(v) for v in args.mesh.split(","))
    else:
        dp, sp = (1 if avail is None else len(avail)), 1
    devs = [torch.device("cpu")] * (dp * sp) if avail is None else avail
    if dp * sp > len(devs):
        raise SystemExit(f"mesh {dp}x{sp} needs {dp * sp} devices, have {len(devs)}")
    if args.batch % dp or args.patch % sp:
        raise SystemExit("--batch must divide by dp and --patch by sp")
    model, params, halo, scale, channels = buildModel(args.model, args.scale, fromScratch=args.fromScratch)
    if args.patch // sp <= halo:
        raise SystemExit(
            f"--patch/sp = {args.patch // sp} rows per shard must exceed the model's halo ({halo}; edge shards "
            f"reflect-pad from their own rows); raise --patch or lower sp")
    mesh = makeMesh([dp, sp], devices=devs[: dp * sp])
    home = mesh.flat[0]

    masters = {k: v.to(home, torch.float32).requires_grad_() for k, v in params.items()}
    optimizer = torch.optim.Adam(masters.values(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    startStep = 0

    ckptPath = os.path.join(os.path.abspath(args.out), "state")
    ckptFile = os.path.join(ckptPath, "train.pt")
    if args.resume and os.path.isfile(ckptFile):
        restored = torch.load(ckptFile, map_location=home, weights_only=True)
        with torch.no_grad():
            for k, v in restored["params"].items():
                masters[k].copy_(v)
        optimizer.load_state_dict(restored["optState"])
        startStep = int(restored["step"])
        print(f"resumed from step {startStep}")

    sampler = PatchSampler(sorted(glob.glob(args.data)), args.patch, scale, args.seed + startStep,
                           channels=channels, sigma=args.sigma)
    step = makeOptaxTrainStep(model, mesh, optimizer, halo=halo, scale=scale,
                              computeDtype=torch.bfloat16 if args.computeDtype == "bf16" else None)

    evalSampler = None
    if args.holdout:
        evalSampler = PatchSampler(sorted(glob.glob(args.holdout)), args.patch, scale, args.seed + 99,
                                   channels=channels, sigma=args.sigma)

    psnrBefore = None
    if evalSampler is not None:
        psnrBefore = evalPSNR(model, masters, evalSampler, device=home)
        print(f"held-out PSNR before: {psnrBefore:.2f} dB", flush=True)

    def save(n):
        os.makedirs(ckptPath, exist_ok=True)
        state = {"params": {k: v.detach() for k, v in masters.items()}, "optState": optimizer.state_dict(),
                 "step": n}
        torch.save(state, ckptFile + ".tmp")
        os.replace(ckptFile + ".tmp", ckptFile)

    loss = None
    for n in range(startStep, args.steps):
        x, y = sampler.batch(args.batch)
        _, loss = step(masters, torch.from_numpy(x).to(home), torch.from_numpy(y).to(home))
        if (n + 1) % 20 == 0 or n == startStep:
            print(f"step {n + 1}/{args.steps} loss {float(loss):.5f}", flush=True)
        if (n + 1) % args.saveEvery == 0:
            save(n + 1)
    save(args.steps)
    if loss is not None:
        print(f"done: {args.steps} steps, final loss {float(loss):.5f}")
    if evalSampler is not None:
        psnrAfter = evalPSNR(model, masters, evalSampler, device=home)
        print(f"held-out PSNR after: {psnrAfter:.2f} dB ({psnrAfter - psnrBefore:+.2f})", flush=True)
    return {k: v.detach().cpu() for k, v in masters.items()}


if __name__ == "__main__":
    main()
