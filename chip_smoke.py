"""GPU smoke test of the PyTorch/CUDA port (moephoto_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    builds every CUDA kernel of the main paths from csrc/, one
              nvcc per source, all started together
  3. kernels  holds each kernel against its plain PyTorch version on the
              card at the main paths' shapes: fusedUpHeads in fp32 (TF32
              off) and bf16; ailutTransform at 1080p in range and out of
              range, with a batch of 2 and a ragged pixel count, and on
              values that equal vertices
  4. main     runs the CLI's image SR path (MoeNet_lite2 x4, bf16) on a
              seeded 1920x1080 PNG with seeded random weights, checks the
              7680x4320 output and the kernel launch count, and holds a
              256x256 crop run on the card in fp32 against the CPU path
  5. retouch  runs the CLI's retouch chain (sun demoire -> AOD dehaze ->
              AiLUT_sRGB_3) on a seeded 1920x1080 PNG, checks the output
              and the one AiLUT launch, and prints the share of AiLUT
              inputs outside the vertex range; holds the chain on a
              256x256 crop in fp32 on the card against the CPU, and
              AiLUT's codes, LUT and vertices on a 1080p image (both
              backbones, process-wide TF32 switched on) against the CPU
  6. timing   1080p x4 throughput through ModelExec (CUDA events), each
              kernel's time beside its plain version and its bound, and
              a profiler breakdown of one image by kernel name; then the
              same for each retouch step and the chain
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
RETOUCH = [{"op": "dehaze", "model": "sun"}, {"op": "dehaze", "model": "dehaze"},
           {"op": "dehaze", "model": "AiLUT_sRGB_3"}]
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
# ailutTransform vs its plain version: the kernel rounds each fp32
# operation where the plain version does, so they should agree exactly;
# extrapolated outputs reach far above 1, hence the relative form
LUT_TOL = 1e-5
# retouch crop on the card vs CPU, fp32, relative to max(1, |cpu|): sun's
# and AOD's convs differ by up to ~1e-4 (cuDNN algorithms, as CROP_TOL);
# outside the vertex range AiLUT multiplies an input error by a LUT step
# over an interval (~0.05 / 0.03) and a vertex error by a fraction of
# several units over an interval, so allow 20x that
CHAIN_TOL = 2e-3
# AiLUT codes, LUT and vertices on the card vs CPU, relative to the
# largest |value|: fp32 convs differ by ~1e-5 between cuDNN and the CPU;
# TF32 (10-bit mantissa) would give ~1e-3
GEN_TOL = 1e-4
LUT_FLOP_PER_PX = 79  # ailut.cu: 3 x 5 for the fractions, 3 + 16 for weights, 3 x 15 for the sums


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


def profileOnce(fn):
    """One call of ``fn`` under the profiler: its wall ms and the device
    ms of each kernel name, largest first.  Only device-side events
    (kernels, copies) count: the operators that launch them also carry
    device time, and counting both would count it twice."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wallMs = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return wallMs, sorted(rows, key=lambda r: -r[1])


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

    src, dst = os.path.join(work, "in.png"), os.path.join(work, "out.png")
    rgb = np.random.RandomState(seed).randint(0, 256, (H, W, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(src)
    resetCounts()
    t0 = time.perf_counter()
    cli.runImage(src, dst, STEPS)
    seconds = time.perf_counter() - t0
    counts = readCounts()
    launches = counts["fusedUpHeads"]
    with Image.open(dst) as out:
        size, mode = out.size, out.mode
        arr = np.asarray(out)
    if size != (W * UPSCALE, H * UPSCALE) or mode != "RGB":
        raise AssertionError(f"output {size} {mode}, want {(W * UPSCALE, H * UPSCALE)} RGB")
    if launches != 4:  # 40 tiles of 256 px in chunks of 10
        raise AssertionError(f"fusedUpHeads launched {launches} times on the main path, want 4")
    emit(phase="main", steps=STEPS, input=[H, W, 3], output=list(arr.shape), seconds=seconds,
         dtype=str(config.dtype()), launches=counts,
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
    wallMs, rows = profileOnce(lambda: ex(x))
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


def resetCounts():
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.lut import ailutTransform

    fusedUpHeads.launches = ailutTransform.launches = 0


def readCounts():
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.lut import ailutTransform

    return {"fusedUpHeads": fusedUpHeads.launches, "ailutTransform": ailutTransform.launches}


def lutBound(img, lut, vertices):
    """Least time for ailutTransform on these inputs: the image, the LUT
    and the vertices read once, the output written once, against the
    fp32 CUDA-core rate for the kernel's operations."""
    nbytes = 2 * img.numel() * img.element_size() + (lut.numel() + vertices.numel()) * 4
    tBytes = nbytes / PEAK_BYTES * 1e3
    tOps = LUT_FLOP_PER_PX * (img.numel() // 3) / PEAK_FP32_FLOPS * 1e3
    return max(tOps, tBytes), ("operations" if tOps > tBytes else "bytes")


def lutCase(seed, B, H, W, lo, hi, D=33):
    """Seeded image in [lo, hi), random LUT, sorted non-uniform vertices
    from 0 to 1 (a softmax cumsum, as AiLUT makes them), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((B, H, W, 3), generator=g, device="cuda") * (hi - lo) + lo
    lut = torch.rand((B, 3, D, D, D), generator=g, device="cuda")
    logits = 0.3 * torch.randn((B, 3, D - 1), generator=g, device="cuda")
    vertices = torch.nn.functional.pad(torch.softmax(logits, -1).cumsum(-1), (1, 0)).contiguous()
    return img, lut, vertices


def checkLut(seed):
    """ailutTransform against ailutTransformPlain on the card."""
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformPlain

    cases = {
        "1080p_in_range": (1, H, W, 0.0, 1.0),
        "1080p_extrapolate": (1, H, W, -0.4, 1.5),
        "B2_ragged_37x1001": (2, 37, 1001, -0.2, 1.2),
        "ties_33x99": (1, 33, 99, 0.0, 1.0),
    }
    errs, outside = {}, {}
    for i, (name, (B, h, w, lo, hi)) in enumerate(cases.items()):
        img, lut, vertices = lutCase(seed + 10 + i, B, h, w, lo, hi)
        if name.startswith("ties"):  # every pixel on a vertex: v[0] .. v[D-1] in turn
            img = vertices[:, :, None, :].expand(B, 3, h, 33).permute(0, 2, 3, 1).repeat(1, 1, w // 33, 1)
            img = img.contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            got = ailutTransform(x, lut, vertices).float()
            want = ailutTransformPlain(x, lut, vertices).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            tol = LUT_TOL * want.abs().clamp_min(1.0)
            if dtype == torch.bfloat16:  # a sum near a rounding boundary may round the other way
                tol = tol + 2.0**-7 * want.abs()
            key = f"{name}_{str(dtype)[6:]}"
            errs[key] = float(diff.max())
            if not (bool((diff <= tol).all()) and bool(torch.isfinite(got).all())):
                raise AssertionError(f"ailutTransform disagrees with its plain version: {key} max {errs[key]}")
        v0, v1 = vertices[:, :, 0][:, None, None, :], vertices[:, :, -1][:, None, None, :]
        outside[name] = float(((img < v0) | (img > v1)).float().mean())
        del img, lut, vertices, got, want, diff
    emit(phase="kernels", kernel="ailutTransform", fp32_tol=f"{LUT_TOL}*max(1,|plain|)",
         bf16_tol=f"{LUT_TOL}*max(1,|plain|)+2^-7*|plain|", max_abs_err=errs, share_outside_vertices=outside)
    return max(v for k, v in errs.items() if k.endswith("float32"))


class AiLUTInputs:
    """Keeps the input of every AiLUT forward while installed (a global
    forward pre-hook), so the script can read what the real path fed it."""

    def __enter__(self):
        from moephoto_tpu_torch.models.ailut import AiLUT

        self.seen = []

        def hook(module, args):
            if isinstance(module, AiLUT):
                self.seen.append((module, args[0].detach().clone()))

        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()
        return False


def runRetouch(seed, work):
    """The CLI's retouch chain, as a user calls it, on the card (sun and
    AOD in bf16, AiLUT in fp32)."""
    from PIL import Image

    from moephoto_tpu_torch import cli

    src, dst = os.path.join(work, "retouch_in.png"), os.path.join(work, "retouch_out.png")
    rgb = np.random.RandomState(seed + 2).randint(0, 256, (H, W, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(src)
    with AiLUTInputs() as seen:
        resetCounts()
        t0 = time.perf_counter()
        cli.runImage(src, dst, RETOUCH)
        seconds = time.perf_counter() - t0
        launches = readCounts()
    with Image.open(dst) as out:
        size, mode = out.size, out.mode
        arr = np.asarray(out)
    if size != (W, H) or mode != "RGB" or arr.shape != (H, W, 3):
        raise AssertionError(f"retouch output {size} {mode}, want {(W, H)} RGB")
    if launches["ailutTransform"] != 1 or len(seen.seen) != 1:
        raise AssertionError(f"retouch chain launched {launches}, want 1 ailutTransform")
    if not arr.std() > 0:
        raise AssertionError("retouch output is constant")
    model, x = seen.seen[0]
    with torch.inference_mode():
        _, _, vertices = model.generate(x)
    lo, hi = vertices[0, :, 0], vertices[0, :, -1]
    below = [float((x[..., c] < lo[c]).float().mean()) for c in range(3)]
    above = [float((x[..., c] > hi[c]).float().mean()) for c in range(3)]
    if not sum(below) + sum(above) > 0:
        raise AssertionError("no AiLUT input left the vertex range: extrapolation not exercised")
    emit(phase="retouch", steps=RETOUCH, input=[H, W, 3], output=list(arr.shape), seconds=seconds,
         launches=launches, ailut_input_shape=list(x.shape), ailut_input_dtype=str(x.dtype),
         share_below_v0=below, share_above_vlast=above,
         ailut_input_min=float(x.min()), ailut_input_max=float(x.max()),
         output_mean=float(arr.mean()), output_std=float(arr.std()))
    return launches["ailutTransform"], x, model


def retouchExecs(dev, seed):
    """sun, AOD and AiLUT_sRGB_3 as the registry builds them, in fp32 on
    ``dev``, with the synthetic weights the retouch run loads."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.models.ailut import AiLUT
    from moephoto_tpu_torch.models.demoire import SunDemoire
    from moephoto_tpu_torch.models.restore import AODNet
    from moephoto_tpu_torch.pipeline.registry import DEHAZE_REGISTRY
    from moephoto_tpu_torch.synth import synthAiLUTParams, synthAODParams, synthSunParams

    out = []
    for key, make, sd in (("sun", SunDemoire, synthSunParams(seed)), ("dehaze", AODNet, synthAODParams(seed)),
                          ("AiLUT_sRGB_3", lambda: AiLUT(3, 33, "tpami"), synthAiLUTParams("tpami", 3, seed))):
        entry = DEHAZE_REGISTRY[key]
        model = make()
        model.load_state_dict(sd, strict=True)
        ex = ModelExec(model.to(dev).eval(), entry["spec"], prepare=entry["prepare"],
                       dtype=torch.float32, device=dev)
        out.append(ex.applyWhole if entry["noTile"] else ex)
    return out


def checkRetouchCrop(seed):
    """The chain on a 256x256 crop, fp32, on the card against the CPU."""
    x = torch.from_numpy(np.random.RandomState(seed + 3).rand(256, 256, 3).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        y = x
        for step in retouchExecs(dev, seed):
            y = step(y)
        outs.append(y.cpu())
    err = (outs[0] - outs[1]).abs()
    bound = CHAIN_TOL * outs[1].abs().clamp_min(1.0)
    if not (bool((err <= bound).all()) and bool(torch.isfinite(outs[0]).all())):
        raise AssertionError(f"retouch crop on the card differs from the CPU by {float(err.max())}")
    emit(phase="retouch_crop", shape=list(outs[0].shape), max_abs_err=float(err.max()),
         max_rel_err=float((err / outs[1].abs().clamp_min(1.0)).max()), tol=f"{CHAIN_TOL}*max(1,|cpu|)",
         cpu_min=float(outs[1].min()), cpu_max=float(outs[1].max()))


def checkGenerate(seed):
    """AiLUT's codes, LUT and vertices for a 1080p image on the card
    against the CPU, both backbones, with the process-wide TF32 flags ON:
    the module must switch TF32 off for itself."""
    from moephoto_tpu_torch.models.ailut import AiLUT
    from moephoto_tpu_torch.models.api import resizeBilinear
    from moephoto_tpu_torch.synth import synthAiLUTParams

    x = torch.from_numpy(np.random.RandomState(seed + 4).rand(1, H, W, 3).astype(np.float32))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    report = {}
    try:
        for backbone, ranks in (("tpami", 3), ("res18", 5)):
            sd = synthAiLUTParams(backbone, ranks, seed)
            res = {}
            for dev in ("cuda", "cpu"):
                model = AiLUT(ranks, 33, backbone)
                model.load_state_dict(sd, strict=True)
                model = model.to(dev).eval()
                with torch.inference_mode():
                    res[dev] = [t.cpu() for t in model.generate(x.to(dev))]
                    if dev == "cuda":  # the same backbone outside the module's scope, for scale
                        size = model.backbone.inputSize
                        xr = resizeBilinear(x.to(dev), size, size).permute(0, 3, 1, 2)
                        tf32Codes = model.backbone(xr).reshape(1, -1).cpu()
            errs = {}
            for name, a, b in zip(("codes", "lut", "vertices"), res["cuda"], res["cpu"]):
                errs[name] = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                if not errs[name] <= GEN_TOL:
                    raise AssertionError(f"AiLUT {backbone} {name} on the card differ from the CPU by {errs[name]}")
            errs["codes_tf32_outside_module"] = (float((tf32Codes - res["cpu"][0]).abs().max())
                                                 / max(1.0, float(res["cpu"][0].abs().max())))
            report[backbone] = errs
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    emit(phase="ailut_generate", input=[1, H, W, 3], global_tf32=True, tol=f"{GEN_TOL} of max|cpu|",
         rel_err=report)


def timingRetouch(seed, gpu, lutInput, lutModel):
    """Per-step and chain ms per 1080p image on a device-resident image,
    a profiler breakdown of one chain, and K4 beside its plain version
    and its bound on the input the chain gave AiLUT."""
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformPlain
    from moephoto_tpu_torch.pipeline import registry

    sun, aod, lut = (registry.getDehaze({"model": m["model"]}) for m in RETOUCH)  # built by the CLI run
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((H, W, 3), generator=g, device="cuda")
    xs = sun(x)
    xa = aod(xs)
    steps = {"sun": lambda: sun(x), "dehaze": lambda: aod(xs), "AiLUT_sRGB_3": lambda: lut.applyWhole(xa),
             "chain": lambda: lut.applyWhole(aod(sun(x)))}
    ms = {}
    for name, fn in steps.items():
        for _ in range(WARMUP):
            fn()
        ms[name] = cudaTimeMs(fn, ITERS)

    profiled = {}
    for name, fn in steps.items():  # one profiled call each: device time and idle share
        wallMs, rows = profileOnce(fn)
        deviceMs = sum(t for _, t in rows)
        profiled[name] = {"wall_ms": wallMs, "device_ms": deviceMs,
                          "device_idle_share": (1 - deviceMs / wallMs) if wallMs else None}
    emit(phase="retouch_timing", gpu=gpu, ms_per_image=ms, iters=ITERS, warmup=WARMUP, profiled=profiled,
         chain_top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:16]],
         chain_ailut_kernel_ms=sum(t for k, t in rows if "ailutKernel" in k))

    with torch.inference_mode():
        _, table, vertices = lutModel.generate(lutInput)
    img = lutInput.contiguous()
    wrapperMs = cudaTimeMs(lambda: ailutTransform(img, table, vertices), ITERS)
    plainMs = cudaTimeMs(lambda: ailutTransformPlain(img, table, vertices), 3)
    # the kernel's own device time: the wrapper's host work and its LUT
    # re-layout are not part of it (the event time above includes both)
    _, rows = profileOnce(lambda: [ailutTransform(img, table, vertices) for _ in range(ITERS)])
    rows = {k: t / ITERS for k, t in rows}
    kMs = sum(t for k, t in rows.items() if "ailutKernel" in k)
    bound, boundBy = lutBound(img, table, vertices)
    emit(phase="kernel_timing", gpu=gpu, kernel="ailutTransform", shape=list(img.shape), D=table.shape[-1],
         ms=kMs, wrapper_ms=wrapperMs, plain_ms=plainMs, bound_ms=bound, bound_by=boundBy,
         gbytes_per_s=(2 * img.numel() * 4) / (kMs / 1e3) / 1e9,
         device_ms_per_call={k[:80]: t for k, t in rows.items()})
    return dict(ms=kMs, plain_ms=plainMs, bound_ms=bound, bound_by=boundBy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.ops import _build, fusedup, lut
    from moephoto_tpu_torch.synth import synthAiLUTParams, synthAODParams, synthLite2Params, synthSunParams

    # fp32 comparisons run in true fp32: cuDNN would run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    sources = (fusedup.SOURCE, lut.SOURCE)
    _build.loadAll(sources)
    emit(phase="build", seconds=time.perf_counter() - t0, libraries={src: {
        "nvcc_seconds": _build.buildInfo[src]["seconds"],
        "library": os.path.relpath(_build.libraryPath(src), ROOT),
        "ptxas": [ln.strip() for ln in _build.buildInfo[src]["log"].splitlines()
                  if "registers" in ln or "spill" in ln]} for src in sources})

    errs = checkKernel(args.seed)
    lutErr = checkLut(args.seed)

    config.device, config.bf16 = "cuda", True
    with tempfile.TemporaryDirectory() as work:
        for sub, name, sd in (("lite", "model_4.pth", synthLite2Params(UPSCALE, args.seed)),
                              ("demoire", "sun_epoch_200.pth", synthSunParams(args.seed)),
                              ("dehaze", "AOD_net_epoch_relu_10.pth", synthAODParams(args.seed)),
                              ("AiLUT", "AiLUT-FiveK-sRGB.pth", synthAiLUTParams("tpami", 3, args.seed))):
            os.makedirs(os.path.join(work, sub), exist_ok=True)
            torch.save(sd, os.path.join(work, sub, name))
        config.modelDir = work
        launches = runMainPath(args.seed, work)
        checkCrop(args.seed)
        lutLaunches, lutInput, lutModel = runRetouch(args.seed, work)
        checkRetouchCrop(args.seed)
        checkGenerate(args.seed)
        kt = timing(args.seed, smi)
        lt = timingRetouch(args.seed, smi, lutInput, lutModel)

    print(json.dumps({"kernels": [{
        "name": "fusedUpHeads", "route": "cuda", "source": "moephoto_tpu_torch/csrc/fusedup.cu",
        "replaces": "moephoto_tpu/ops/fusedup.py:93", "launches": launches,
        "max_abs_err": errs["nUps2_c48_M1966080_bfloat16"], "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"], "library_ms": None,
    }, {
        "name": "ailutTransform", "route": "cuda", "source": "moephoto_tpu_torch/csrc/ailut.cu",
        "replaces": "moephoto_tpu/ops/lutkernel.py:185", "launches": lutLaunches,
        "max_abs_err": lutErr, "ms": lt["ms"], "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
