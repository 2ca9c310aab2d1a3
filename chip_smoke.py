"""GPU smoke test of the PyTorch/CUDA port (moephoto_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    builds every CUDA kernel of the main path from csrc/
  3. kernels  holds each kernel against its plain PyTorch version on the
              card at the main path's shapes, in fp32 (TF32 off) and bf16
  4. main     runs the CLI's image SR path (MoeNet_lite2 x4, bf16) on a
              seeded 1920x1080 PNG with seeded random weights, checks the
              7680x4320 output and the kernel launch count, and holds a
              256x256 crop run on the card in fp32 against the CPU path
  5. timing   1080p x4 throughput through ModelExec (CUDA events), each
              kernel's time beside its plain version and its bound, and
              a profiler breakdown of one image by kernel name
Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero without that last line; with no CUDA device it
exits 1 before doing anything.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, UPSCALE = 1080, 1920, 4
STEPS = [{"op": "SR", "model": "lite", "scale": UPSCALE}]
WARMUP, ITERS = 2, 10
# H100 SXM dense peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
FP32_TOL = 1e-4  # kernel vs plain in fp32: only the fp32 sum order differs
# bf16: a stage value whose fp32 sum lands near a rounding boundary can
# round the other way; allow a few bf16 ulps relative plus a small floor
BF16_REL, BF16_ABS = 2.0**-6, 2.0**-6
# crop on the card vs CPU, both fp32: cuDNN may pick Winograd/FFT algorithms
# for 3x3 convs, whose errors reach ~1e-4 of the values over nine layers
CROP_TOL = 1e-3


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cudaTimeMs(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def upBound(M: int, c: int, nUps: int, cout: int, itemSize: int, peakFlops: float):
    """Least time for fusedUpHeads on these shapes: each input read once,
    the output written once, against the card's peak rate for the type."""
    S = 4**nUps
    macs = M * 2 * sum(4**k for k in range(1, nUps + 1)) * c * c + M * S * 2 * c * cout
    weights = 2 * nUps * 4 * c * c * itemSize + 2 * nUps * 5 * c * 4 + 2 * cout * (c + 1) * 4
    nbytes = 2 * M * c * itemSize + M * S * cout * itemSize + weights
    tOps, tBytes = 2 * macs / peakFlops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(tOps, tBytes), ("operations" if tOps >= tBytes else "bytes")


def upCase(ups, pack, M, dtype, seed):
    from moephoto_tpu_torch.models.api import packBlockDiag
    from moephoto_tpu_torch.synth import synthLite2Params

    sd = synthLite2Params(ups, seed)
    if pack > 1:
        sd = packBlockDiag(sd, pack)
    params = {k: v.to("cuda", dtype) for k, v in sd.items()}
    g = torch.Generator(device="cuda").manual_seed(seed + M)
    c = 48 * pack
    res = torch.randn((M, c), generator=g, device="cuda").to(dtype)
    im = torch.randn((M, c), generator=g, device="cuda").to(dtype)
    return params, res, im, int(ups).bit_length() - 1


def checkKernel(seed):
    """fusedUpHeads against fusedUpHeadsPlain on the card."""
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads, fusedUpHeadsPlain

    mainM = 10 * 3 * 256 * 256  # one x4 chunk: 10 tiles x 3 planes x 256^2 rows
    cases = [(4, 1, mainM), (2, 1, 100_003), (8, 1, 50_001), (4, 2, 20_001)]
    errs = {}
    for ups, pack, M in cases:
        for dtype in (torch.float32, torch.bfloat16):
            params, res, im, nUps = upCase(ups, pack, M, dtype, seed)
            got = fusedUpHeads(params, res, im, nUps).float()
            want = fusedUpHeadsPlain(params, res, im, nUps).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if dtype == torch.float32:
                ok = bool((diff <= FP32_TOL).all())
            else:
                ok = bool((diff <= BF16_REL * want.abs() + BF16_ABS).all())
            name = f"nUps{nUps}_c{48 * pack}_M{M}_{str(dtype)[6:]}"
            errs[name] = float(diff.max())
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(f"fusedUpHeads disagrees with its plain version: {name} max {errs[name]}")
            del params, res, im, got, want, diff
    emit(phase="kernels", kernel="fusedUpHeads", fp32_tol=FP32_TOL,
         bf16_tol=f"{BF16_REL}*|plain|+{BF16_ABS}", max_abs_err=errs)
    return errs


def runMainPath(seed, work):
    """The CLI's image path, as a user calls it, on the card in bf16."""
    from PIL import Image

    from moephoto_tpu_torch import cli
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads

    src, dst = os.path.join(work, "in.png"), os.path.join(work, "out.png")
    rgb = np.random.RandomState(seed).randint(0, 256, (H, W, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(src)
    fusedUpHeads.launches = 0
    t0 = time.perf_counter()
    cli.runImage(src, dst, STEPS)
    seconds = time.perf_counter() - t0
    launches = fusedUpHeads.launches
    with Image.open(dst) as out:
        size, mode = out.size, out.mode
        arr = np.asarray(out)
    if size != (W * UPSCALE, H * UPSCALE) or mode != "RGB":
        raise AssertionError(f"output {size} {mode}, want {(W * UPSCALE, H * UPSCALE)} RGB")
    if launches != 4:  # 40 tiles of 256 px in chunks of 10
        raise AssertionError(f"fusedUpHeads launched {launches} times on the main path, want 4")
    emit(phase="main", steps=STEPS, input=[H, W, 3], output=list(arr.shape), seconds=seconds,
         dtype=str(config.dtype()), launches={"fusedUpHeads": launches},
         output_mean=float(arr.mean()), output_std=float(arr.std()))
    return launches


def checkCrop(seed):
    """A 256x256 crop through ModelExec on the card in fp32 (kernel path)
    against the CPU (plain path), same weights."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.pipeline.registry import SR_REGISTRY
    from moephoto_tpu_torch.synth import synthLite2Params

    spec = dataclasses.replace(SR_REGISTRY["lite4"]["spec"], batch=1)  # one tile: quick on the CPU
    x = torch.from_numpy(np.random.RandomState(seed + 1).rand(256, 256, 3).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        model = MoeNetLite2(UPSCALE)
        model.load_state_dict(synthLite2Params(UPSCALE, seed), strict=True)
        model = model.to(dev).eval()
        ex = ModelExec(model, spec, channelSplit=True, dtype=torch.float32, device=dev)
        outs.append(ex(x).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    if not (err <= CROP_TOL and torch.isfinite(outs[0]).all()):
        raise AssertionError(f"card crop differs from the CPU path by {err}")
    emit(phase="crop", shape=list(outs[0].shape), max_abs_err=err, tol=CROP_TOL)


def timing(seed, gpu):
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads, fusedUpHeadsPlain
    from moephoto_tpu_torch.pipeline import registry

    ex = registry.getSR({"model": "lite", "scale": UPSCALE})  # built by the main path
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((H, W, 3), generator=g, device="cuda")
    for _ in range(WARMUP):
        ex(x)
    msImage = cudaTimeMs(lambda: ex(x), ITERS)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex(x)
        torch.cuda.synchronize()
        wallMs = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the operators that launch
    # them also carry device time, and counting both would count it twice
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    deviceMs = sum(t for _, t in rows)
    emit(phase="timing", gpu=gpu, mpx_per_s=(H * W / 1e6) / (msImage / 1e3), ms_per_image=msImage,
         iters=ITERS, warmup=WARMUP, profiled_wall_ms=wallMs, profiled_device_ms=deviceMs,
         device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
         top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:10]])

    params, res, im, nUps = upCase(UPSCALE, 1, 10 * 3 * 256 * 256, torch.bfloat16, seed)
    ms = cudaTimeMs(lambda: fusedUpHeads(params, res, im, nUps), ITERS)
    plainMs = cudaTimeMs(lambda: fusedUpHeadsPlain(params, res, im, nUps), 3)
    bound, boundBy = upBound(res.shape[0], 48, nUps, 1, 2, PEAK_BF16_FLOPS)
    p32, r32, i32, _ = upCase(UPSCALE, 1, 10 * 3 * 256 * 256, torch.float32, seed)
    ms32 = cudaTimeMs(lambda: fusedUpHeads(p32, r32, i32, nUps), ITERS)
    bound32, _ = upBound(res.shape[0], 48, nUps, 1, 4, PEAK_FP32_FLOPS)
    emit(phase="kernel_timing", gpu=gpu, kernel="fusedUpHeads", M=res.shape[0], c=48, nUps=nUps,
         bf16_ms=ms, bf16_plain_ms=plainMs, bf16_bound_ms=bound, bound_by=boundBy,
         fp32_ms=ms32, fp32_bound_ms_cuda_cores=bound32)
    return dict(ms=ms, plain_ms=plainMs, bound_ms=bound, bound_by=boundBy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.ops import _build, fusedup
    from moephoto_tpu_torch.synth import synthLite2Params

    # fp32 comparisons run in true fp32: cuDNN would run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.load(fusedup.SOURCE)
    info = _build.buildInfo[fusedup.SOURCE]
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         library=os.path.relpath(_build.libraryPath(fusedup.SOURCE), ROOT),
         ptxas=[ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln])

    errs = checkKernel(args.seed)

    config.device, config.bf16 = "cuda", True
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "lite"))
        torch.save(synthLite2Params(UPSCALE, args.seed), os.path.join(work, "lite", "model_4.pth"))
        config.modelDir = work
        launches = runMainPath(args.seed, work)
        checkCrop(args.seed)
        kt = timing(args.seed, smi)

    print(json.dumps({"kernels": [{
        "name": "fusedUpHeads", "route": "cuda", "source": "moephoto_tpu_torch/csrc/fusedup.cu",
        "replaces": "moephoto_tpu/ops/fusedup.py:93", "launches": launches,
        "max_abs_err": errs["nUps2_c48_M1966080_bfloat16"], "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
