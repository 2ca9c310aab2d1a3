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
              values that equal vertices; warp at IFRNet-M's four 1080p
              warp shapes, a ragged shape, B = 2 and a stride-0 batch,
              both padding modes, fp32 and bf16, flows up to 40 px, 1e6
              and NaN, and backWarp against its plain fold; the DCNv2
              sampler (K3) at EDVR's three 640x360 shapes in bf16 and
              fp32 (TF32 off), ragged shapes, dg 4 and 8, B = 1, Cout 96,
              16-byte and scalar corner loads, offsets up to 40 px, 1e6
              and NaN, offsets and mask read as strided slices of one
              conv output; ailutTransformClamped (K5) at 1080p in and out
              of range with differing channel ranges, B = 2 ragged, NaN
              pixels, disjoint ranges (lo > hi), fp32 and bf16
     parity   the kernel parity gate (tools/chipparity.py runAll and
              assertAll): all five kernels against their plain versions on
              the JAX gate's six cases, each launched once
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
  7. video    runs the CLI's video path (fake ffmpeg decode -> buffer ->
              IFRNet-M slomo x2 in bf16 -> output -> fake ffmpeg encode)
              on 9 seeded-pattern 1920x1080 frames with seeded random
              weights, checks 17 encoded frames and 64 warp launches, and
              prints the largest |flow| each warp shape saw; holds the
              slomo stream on 5 frames of 128x128 in fp32 on the card
              against the CPU; then times the slomo stream on
              device-resident 1080p frames (output Mpx/s, a profiled
              chunk), and the warp at each of its four shapes on the
              inputs the CLI run gave it, beside its bound, its plain
              version and F.grid_sample (and on incoherent 40 px flows)
  8. vsr      runs the CLI's video path with IconVSR x4 (fake ffmpeg
              decode -> buffer -> VSR in bf16 -> output -> fake ffmpeg
              encode) on 22 seeded-pattern 640x360 frames with seeded
              random weights (full width, 30-block trunks): checks 22
              encoded 2560x1440 frames, 4 DCN launches per EDVR call the
              model counted, and prints the K2 launches and the largest
              |offset| each DCN level saw; holds the VSR stream on 9
              frames of 128x128 in fp32 on the card against the CPU;
              then times whole 22-frame clips on device-resident frames
              (input Mpx/s, a profiled clip by kernel name) and K3 at
              each of its three shapes on the inputs the CLI run gave
              it, beside its bound and its plain version
  9. dn       runs the CLI's image path on the denoise -> SR chain (DN
              lite5 -> SR lite x4, bf16) on a seeded 1920x1080 PNG, checks
              the 7680x4320 output and the 4 K1 launches; then on the image
              steps of the reference's benchmark preset (SR lite x2 ->
              resize 1280x720 -> DN lite5 -> SR a x2 -> dehaze) on a
              seeded 1280x720 PNG, checks the 2560x1440 output; holds a
              128x128 crop of NetDN, SEDN and MyNet x2 and the three
              resize methods on the card in fp32 against the CPU; then
              times DN lite5, DN 15 (SEDN), SR a x2 and the chain on a
              device-resident 1080p image (Mpx/s by CUDA events, device
              ms, idle share and top kernels from one profiled call), and
              K5 alone at 1080p and at the gate's 32x64
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
SLOMO = [{"op": "slomo", "model": "IFRNet M", "sf": 2}]
VIDEO_FRAMES = 9
# warp vs its plain version: the kernel rounds each fp32 operation where
# the plain version does; bf16 allows one ulp of |plain| and 2^-8
WARP_FP32_TOL, WARP_BF16_REL, WARP_BF16_ABS = 1e-5, 2.0**-7, 2.0**-8
# IFRNet's warps per 1080p pair (sf 2, k = 1): (H, W, C, image dtype)
WARP_SHAPES = ((136, 240, 72, torch.bfloat16), (272, 480, 48, torch.bfloat16),
               (544, 960, 32, torch.bfloat16), (1088, 1920, 3, torch.float32))
WARP_FLOP_PER_VALUE, WARP_FLOP_PER_PX = 9, 12  # warp.cu: the blend per channel; coordinates and weights
# slomo on the card vs the CPU, fp32, outputs in [0, 1]: cuDNN's conv
# algorithms differ from the CPU's by ~1e-5 per layer, and the warps
# carry a flow difference times the image gradient through four levels
SLOMO_TOL = 2e-3
VSR = [{"op": "VSR"}]
VSR_H, VSR_W, VSR_FRAMES, VSR_BLOCKS = 360, 640, 22, 30
# K3 vs its plain version: the sampled values agree bit for bit, the
# contraction sums 9 C products in another order (fp32), and bf16 rounds
# the output once, so a sum near a rounding boundary may round the other way
DCN_FP32_TOL, DCN_BF16_REL, DCN_BF16_ABS = 1e-4, 2.0**-7, 2.0**-8
# EDVR's DCNs on one 640x360 clip (7 frames padded to 640x384): (H, W)
DCN_SHAPES = {"l3": (96, 160), "l2": (192, 320), "l1": (384, 640)}
DCN_LEVELS = ("l3", "l2", "l1", "cas")  # call order within one EDVR call
# VSR stream on the card vs the CPU, fp32, outputs around [0, 1]: cuDNN's
# conv algorithms differ from the CPU's by ~1e-5 per layer, through 30-block
# trunks and recurrences whose warps and DCNs turn a coordinate difference
# into a value difference times the local gradient
VSR_TOL = 2e-3
DN_CHAIN = [{"op": "DN", "model": "lite5"}, {"op": "SR", "model": "lite", "scale": 4}]
PRESET_W, PRESET_H = 1280, 720
PRESET = [{"scale": 2, "model": "lite", "ensemble": 0, "op": "SR"},
          {"method": "bilinear", "width": PRESET_W, "height": PRESET_H, "op": "resize"},
          {"model": "lite5", "op": "DN"},
          {"scale": 2, "model": "a", "ensemble": 0, "op": "SR"},
          {"op": "dehaze"}]
# NetDN, SEDN and MyNet crops on the card vs the CPU, fp32, relative to
# max(1, |cpu|): cuDNN's algorithms differ from the CPU's by ~1e-5 a layer,
# through up to 50 conv layers (SEDN)
DN_CROP_TOL = 1e-3
RESIZE_TOL = 1e-5  # the same fp32 weights and sums on both devices, another order


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
    from moephoto_tpu_torch.ops import deform
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformClamped
    from moephoto_tpu_torch.ops.warp import warp

    fusedUpHeads.launches = ailutTransform.launches = warp.launches = deform.deformConv2d.launches = 0
    ailutTransformClamped.launches = 0


def readCounts():
    from moephoto_tpu_torch.ops import deform
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformClamped
    from moephoto_tpu_torch.ops.warp import warp

    return {"fusedUpHeads": fusedUpHeads.launches, "ailutTransform": ailutTransform.launches,
            "warp": warp.launches, "deformConv2d": deform.deformConv2d.launches,
            "ailutTransformClamped": ailutTransformClamped.launches}


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


def isWarpKernel(name: str) -> bool:
    return "::warpVecKernel<" in name or "::warpPixelKernel<" in name


def warpCase(seed, B, h, w, c, dtype, flowDtype, scale):
    """Seeded image in [0, 1) and flow uniform in [-scale, scale], on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((B, h, w, c), generator=g, device="cuda").to(dtype)
    flow = ((torch.rand((B, h, w, 2), generator=g, device="cuda") * 2 - 1) * scale).to(flowDtype)
    return img, flow


def warpBound(img, flow):
    """Least time for one warp: the image read once (a stride-0 batch is
    one image), the flow read once, the output written once, against the
    fp32 CUDA-core rate for its operations."""
    B, h, w, c = img.shape
    images = 1 if img.stride(0) == 0 else B
    nbytes = (images + B) * h * w * c * img.element_size() + flow.numel() * flow.element_size()
    tBytes = nbytes / PEAK_BYTES * 1e3
    tOps = B * h * w * (WARP_FLOP_PER_VALUE * c + WARP_FLOP_PER_PX) / PEAK_FP32_FLOPS * 1e3
    return max(tOps, tBytes), ("operations" if tOps > tBytes else "bytes")


def checkWarp(seed):
    """warp against warpPlain on the card: NaN exactly where the plain
    version is NaN, every other value within the tolerance."""
    from moephoto_tpu_torch.ops.warp import backWarp, backWarpFlow, warp, warpPlain

    bf, f32 = torch.bfloat16, torch.float32
    cases = {f"path_{h}x{w}x{c}_{str(d)[6:]}": (1, h, w, c, d, bf, 40.0) for h, w, c, d in WARP_SHAPES}
    cases.update({
        "ragged_67x129x5_float32": (1, 67, 129, 5, f32, f32, 40.0),
        "ragged_37x1001x36_bfloat16": (1, 37, 1001, 36, bf, f32, 40.0),
        "B2_272x480x48_bfloat16": (2, 272, 480, 48, bf, bf, 40.0),
        "B2_1088x1920x3_float32": (2, 1088, 1920, 3, f32, f32, 40.0),
        "huge_136x240x72_float32": (1, 136, 240, 72, f32, f32, 1e6),
    })
    errs = {}

    def hold(key, got, want):
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"warp NaNs differ from its plain version: {key}")
        fp32 = want.dtype == torch.float32
        got, want = got.float()[~nan], want.float()[~nan]
        diff = (got - want).abs()
        tol = WARP_FP32_TOL if fp32 else WARP_BF16_REL * want.abs() + WARP_BF16_ABS
        errs[key] = float(diff.max()) if diff.numel() else 0.0
        if not bool((diff <= tol).all()):
            raise AssertionError(f"warp disagrees with its plain version: {key} max {errs[key]}")

    for i, (name, (B, h, w, c, dtype, flowDtype, scale)) in enumerate(cases.items()):
        img, flow = warpCase(seed + 20 + i, B, h, w, c, dtype, flowDtype, scale)
        if name.startswith("huge"):
            flow[0, ::7, ::5] = float("nan")
        for mode in ("border", "zeros"):
            views = {"": img} if B == 1 else {"": img, "_expanded": img[:1].expand_as(img)}
            for tag, x in views.items():
                hold(f"{name}{tag}_{mode}", warp(x, flow, mode), warpPlain(x, flow, mode))
        del img, flow
    img, flow = warpCase(seed + 40, 1, 544, 960, 32, bf, bf, 40.0)
    hold("backWarp_544x960x32_bfloat16", backWarp(img, flow), warpPlain(img, backWarpFlow(flow)))
    torch.cuda.synchronize()
    emit(phase="kernels", kernel="warp", fp32_tol=WARP_FP32_TOL,
         bf16_tol=f"{WARP_BF16_REL}*|plain|+{WARP_BF16_ABS}", max_abs_err=errs)
    return max(errs.values())


def shapeKey(img) -> str:
    return "x".join(str(n) for n in img.shape[1:]) + "_" + str(img.dtype)[6:]


class PathWarps:
    """While installed (it wraps ``ifrnet.warpExact``, which IFRNet's
    warps call): the largest |flow| each warp shape sees, whether any flow
    is NaN, and the first (image, flow) of each shape, kept to time the
    kernel on the inputs the path gave it."""

    def __enter__(self):
        from moephoto_tpu_torch.models import ifrnet

        self.module, self.orig = ifrnet, ifrnet.warpExact
        self.maxFlow, self.nan, self.inputs = {}, {}, {}

        def record(img, flow):
            key = shapeKey(img)
            a = flow.float().abs()
            self.maxFlow[key] = max(self.maxFlow.get(key, 0.0), float(a.nan_to_num(0.0).max()))
            self.nan[key] = self.nan.get(key, False) or bool(torch.isnan(a).any())
            if key not in self.inputs:
                self.inputs[key] = (img.clone(), flow.clone())
            return self.orig(img, flow)

        ifrnet.warpExact = record
        return self

    def __exit__(self, *exc):
        self.module.warpExact = self.orig
        return False


def fakeFfmpeg(work):
    """An executable that runs the repository's fake ffmpeg."""
    path = os.path.join(work, "ffmpeg")
    with open(path, "w") as fp:
        fp.write(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.join(ROOT, "tools", "fakeffmpeg.py")}" "$@"\n')
    os.chmod(path, 0o755)
    return path


def runVideo(work):
    """The CLI's video path, as a user calls it, on the card (IFRNet in
    bf16): 9 decoded 1080p frames -> 17 encoded."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = f"{W}x{H}", str(VIDEO_FRAMES)
    dst = os.path.join(work, "slomo.mkv")
    with PathWarps() as warps:
        resetCounts()
        t0 = time.perf_counter()
        path, frames = cli.runVideo(os.path.join(work, "in.mkv"), dst, SLOMO)
        seconds = time.perf_counter() - t0
        launches = readCounts()
    with open(path) as fp:
        meta = json.load(fp)
    want = (2 * VIDEO_FRAMES - 1) * W * H * 6
    if frames != VIDEO_FRAMES or meta != {"bytes": want, "s": f"{W}x{H}"}:
        raise AssertionError(f"video: read {frames} frames, encoder got {meta}, want {want} bytes of {W}x{H}")
    if launches["warp"] != 8 * (VIDEO_FRAMES - 1):
        raise AssertionError(f"video launched {launches}, want {8 * (VIDEO_FRAMES - 1)} warps")
    emit(phase="video", steps=SLOMO, input=[VIDEO_FRAMES, H, W, 3], frames_read=frames,
         encoded_frames=meta["bytes"] // (W * H * 6), geometry=meta["s"], seconds=seconds, launches=launches,
         max_abs_flow_by_warp_shape=warps.maxFlow, nan_flow_by_warp_shape=warps.nan)
    return launches["warp"], warps.inputs


def slomoStream(opt, collect):
    from moephoto_tpu_torch.models.ifrnet import doSlomo
    from moephoto_tpu_torch.progress import Node

    return doSlomo(lambda x: None if x is None else [collect(x)], Node({"op": "smoke"}), opt)


def checkVideoCrop(seed):
    """The slomo stream on 5 frames of 128x128, IFRNet-M in fp32, on the
    card (kernel path) against the CPU (plain path), same weights."""
    from moephoto_tpu_torch.models.ifrnet import getOpt

    frames = np.random.RandomState(seed + 5).rand(5, 128, 128, 3).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        opt = getOpt(dict(SLOMO[0]), torch.device(dev), torch.float32)
        f = slomoStream(opt, lambda x: x.cpu())
        got = []
        resetCounts()
        for fr in frames:
            got += f(torch.from_numpy(fr).to(dev))
        got += f(None)
        outs[dev] = torch.stack(got)
        launches = readCounts()["warp"]
        if (dev == "cuda") != (launches > 0):
            raise AssertionError(f"video crop on {dev}: {launches} warp launches")
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    if not (outs["cuda"].shape == (9, 128, 128, 3) and err <= SLOMO_TOL and torch.isfinite(outs["cuda"]).all()):
        raise AssertionError(f"video crop: shape {tuple(outs['cuda'].shape)}, card vs CPU {err}")
    emit(phase="video_crop", shape=list(outs["cuda"].shape), max_abs_err=err, tol=SLOMO_TOL)


def timingSlomo(seed, gpu, pathInputs):
    """Output Mpx/s of the slomo stream on device-resident 1080p frames
    (bf16), a profiled chunk, and the warp at each path shape on the
    inputs the CLI run gave it, beside its bound, its plain version and
    F.grid_sample; and the kernel on incoherent flows (each pixel's flow
    uniform in [-40, 40] px, so neighbouring threads gather from unrelated
    lines) at the same shapes."""
    import torch.nn.functional as F

    from moephoto_tpu_torch.models.ifrnet import getOpt
    from moephoto_tpu_torch.ops.warp import warp, warpPlain

    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = [torch.rand((H, W, 3), generator=g, device="cuda") for _ in range(4)]
    f = slomoStream(getOpt(dict(SLOMO[0])), lambda x: x.mean())
    feed = lambda n: sum(len(f(frames[i % 4])) for i in range(n))
    feed(16)  # two chunks of warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outFrames = feed(16)
    end.record()
    torch.cuda.synchronize()
    wallS = time.perf_counter() - t0
    eventS = start.elapsed_time(end) / 1e3
    resetCounts()
    wallMs, rows = profileOnce(lambda: feed(8))  # one chunk: 8 pairs
    launches = readCounts()["warp"]
    deviceMs = sum(t for _, t in rows)
    warpMs = sum(t for k, t in rows if isWarpKernel(k))
    emit(phase="slomo_timing", gpu=gpu, output_frames=outFrames, seconds_events=eventS, seconds_wall=wallS,
         output_mpx_per_s=outFrames * H * W / 1e6 / eventS, profiled_chunk_pairs=8, profiled_warp_launches=launches,
         profiled_wall_ms=wallMs, profiled_device_ms=deviceMs, device_ms_per_interpolated_frame=deviceMs / 8,
         warp_device_ms_per_interpolated_frame=warpMs / 8,
         device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
         top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:16]])

    kernelMs = lambda img, flow: sum(
        t for k, t in profileOnce(lambda: [warp(img, flow) for _ in range(ITERS)])[1] if isWarpKernel(k)) / ITERS
    shapes = {}
    for i, (h, w, c, dtype) in enumerate(WARP_SHAPES):
        key = f"{h}x{w}x{c}_{str(dtype)[6:]}"
        img, flow = pathInputs[key]
        wrapperMs = cudaTimeMs(lambda: warp(img, flow), ITERS)
        plainMs = cudaTimeMs(lambda: warpPlain(img, flow), 3)
        ys, xs = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij")
        grid = torch.stack([2 * (xs + flow[0, ..., 0].float()) / (w - 1) - 1,
                            2 * (ys + flow[0, ..., 1].float()) / (h - 1) - 1], -1)[None].to(dtype)
        nchw = img.permute(0, 3, 1, 2)
        libMs = cudaTimeMs(lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                                 align_corners=True), ITERS)
        bound, boundBy = warpBound(img, flow)
        rImg, rFlow = warpCase(seed + 60 + i, 1, h, w, c, dtype, torch.bfloat16, 40.0)
        shapes[key] = dict(ms=kernelMs(img, flow), wrapper_ms=wrapperMs, plain_ms=plainMs, library_ms=libMs,
                           bound_ms=bound, bound_by=boundBy, path_max_abs_flow=float(flow.float().abs().max()),
                           ms_incoherent_flow_40px=kernelMs(rImg, rFlow))
        del grid, nchw, rImg, rFlow
    emit(phase="kernel_timing", gpu=gpu, kernel="warp", flow_dtype="bfloat16", by_shape=shapes)
    return shapes["544x960x32_bfloat16"]


def isDcnKernel(name: str) -> bool:
    return "::dcnKernel<" in name


def dcnCase(seed, B, h, w, c, cout, dg, dtype, offDtype, scale):
    """Seeded x in [0, 1), offsets uniform in [-scale, scale] and mask in
    (0, 1) read as strided slices of one (B, h, w, 3 dg 9) tensor, as the
    offset conv's output is read; weights at 1/sqrt(fan-in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((B, h, w, c), generator=g, device="cuda").to(dtype)
    off = (torch.rand((B, h, w, 2 * dg * 9), generator=g, device="cuda") * 2 - 1) * scale
    logits = torch.randn((B, h, w, dg * 9), generator=g, device="cuda")
    both = torch.cat([off, torch.sigmoid(logits)], -1).to(offDtype)
    weight = torch.randn((cout, c, 3, 3), generator=g, device="cuda") / (9 * c) ** 0.5
    bias = torch.randn((cout,), generator=g, device="cuda") * 0.1
    return x, both[..., : 2 * dg * 9], both[..., 2 * dg * 9 :], weight, bias, dg


def dcnBound(x, off, mask, cout):
    """Least time for one DCN call: x, the offsets and the mask read once
    (only the offset part of a strided slice), the output written once,
    against the peak rate of x's type for 2 * 9 C Cout operations a pixel."""
    B, h, w, c = x.shape
    px = B * h * w
    nbytes = px * (c * x.element_size() + off.shape[-1] * off.element_size()
                   + mask.shape[-1] * mask.element_size() + cout * x.element_size()) + 9 * c * cout * x.element_size()
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tOps, tBytes = 2 * 9 * c * cout * px / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(tOps, tBytes), ("operations" if tOps > tBytes else "bytes")


def checkDcn(seed):
    """deformConv2d against deformConv2dPlain on the card: NaN exactly
    where the plain version is NaN, every other value within the
    tolerance."""
    from moephoto_tpu_torch.ops.deform import deformConv2d, deformConv2dPlain

    bf, f32 = torch.bfloat16, torch.float32
    cases = {f"path_{lv}_7x{h}x{w}x64_{str(d)[6:]}": (7, h, w, 64, 64, 8, d, d, 2.0)
             for lv, (h, w) in DCN_SHAPES.items() for d in (bf, f32)}
    cases.update({
        "ragged_1x37x101x64_cout96_bfloat16_fp32_offsets": (1, 37, 101, 64, 96, 8, bf, f32, 40.0),
        "ragged_1x37x101x64_float32": (1, 37, 101, 64, 64, 8, f32, f32, 40.0),
        "dg4_2x45x77x32_cout48_bfloat16": (2, 45, 77, 32, 48, 4, bf, bf, 40.0),
        "dg4_2x45x77x32_cout48_float32": (2, 45, 77, 32, 48, 4, f32, f32, 40.0),
        "scalar_loads_1x29x53x12_cout20_dg4_bfloat16": (1, 29, 53, 12, 20, 4, bf, bf, 40.0),
        "huge_nan_1x64x96x64_bfloat16": (1, 64, 96, 64, 64, 8, bf, bf, 1e6),
        "huge_nan_1x64x96x64_float32": (1, 64, 96, 64, 64, 8, f32, f32, 1e6),
    })
    errs = {}
    for i, (name, (B, h, w, c, cout, dg, dtype, offDtype, scale)) in enumerate(cases.items()):
        x, off, mask, weight, bias, dg = dcnCase(seed + 70 + i, B, h, w, c, cout, dg, dtype, offDtype, scale)
        if name.startswith("huge"):  # 1e6 everywhere but a few NaN offsets
            off[0, ::9, ::7, 5] = float("nan")
        got = deformConv2d(x, off, mask, weight, bias, dg).float()
        want = deformConv2dPlain(x, off, mask, weight, bias, dg).float()
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan) or bool(nan.any()) != name.startswith("huge"):
            raise AssertionError(f"deformConv2d NaNs differ from its plain version: {name}")
        diff, ref = (got - want).abs()[~nan], want.abs()[~nan]
        tol = DCN_FP32_TOL * ref.clamp_min(1.0) if dtype == f32 else DCN_BF16_REL * ref + DCN_BF16_ABS
        errs[name] = float(diff.max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"deformConv2d disagrees with its plain version: {name} max {errs[name]}")
        del x, off, mask, got, want, diff
    emit(phase="kernels", kernel="deformConv2d", fp32_tol=f"{DCN_FP32_TOL}*max(1,|plain|)",
         bf16_tol=f"{DCN_BF16_REL}*|plain|+{DCN_BF16_ABS}", max_abs_err=errs)
    return errs["path_l1_7x384x640x64_bfloat16"]


class DcnRecorder:
    """Stands in for ``ops.deform.deformConv2d``: calls ``record`` on each
    call's arguments, then the wrapper; ``launches`` is the wrapper's own
    count, which the wrapper keeps through its module's name."""

    def __init__(self, orig, record):
        self.orig, self.record = orig, record

    def __call__(self, *args):
        self.record(*args)
        return self.orig(*args)

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n


class PathDcn:
    """While installed (a DcnRecorder in place of ``ops.deform.deformConv2d``,
    which every ModulatedDeformConvPack calls): per DCN level, the largest
    |offset|, the shares of offsets above 3 px and below 1 px, and the
    first inputs, kept to time the kernel on what the path gave it; and
    every EDVR module that ran, to read the calls it counted."""

    def __enter__(self):
        from moephoto_tpu_torch.models.iconvsr import EDVR
        from moephoto_tpu_torch.ops import deform

        self.module, self.orig = deform, deform.deformConv2d
        self.maxOffset, self.over3, self.under1, self.inputs, self.nan = {}, {}, {}, {}, False
        self.edvr, self.n = set(), 0

        def record(x, offset, mask, weight, bias, dg, *args):
            lv = DCN_LEVELS[self.n % 4]
            self.n += 1
            a = offset.float().abs()
            self.nan = self.nan or bool(torch.isnan(a).any())
            self.maxOffset[lv] = max(self.maxOffset.get(lv, 0.0), float(a.nan_to_num(0.0).max()))
            self.over3.setdefault(lv, []).append(float((a > 3).float().mean()))
            self.under1.setdefault(lv, []).append(float((a < 1).float().mean()))
            self.inputs.setdefault(lv, (x, offset, mask, weight, bias, dg))

        deform.deformConv2d = DcnRecorder(self.orig, record)

        def hook(module, args):
            if isinstance(module, EDVR):
                self.edvr.add(module)

        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
        return self

    def __exit__(self, *exc):
        self.module.deformConv2d = self.orig
        self.handle.remove()
        return False


def runVsr(work):
    """The CLI's video path with IconVSR x4, as a user calls it, on the
    card in bf16: 22 decoded 640x360 frames -> 22 encoded at 2560x1440."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = f"{VSR_W}x{VSR_H}", str(VSR_FRAMES)
    dst = os.path.join(work, "vsr.mkv")
    with PathDcn() as dcn:
        resetCounts()
        t0 = time.perf_counter()
        path, frames = cli.runVideo(os.path.join(work, "in.mkv"), dst, VSR)
        seconds = time.perf_counter() - t0
        launches = readCounts()
    with open(path) as fp:
        meta = json.load(fp)
    oh, ow = 4 * VSR_H, 4 * VSR_W
    want = VSR_FRAMES * oh * ow * 6
    if frames != VSR_FRAMES or meta != {"bytes": want, "s": f"{ow}x{oh}"}:
        raise AssertionError(f"vsr: read {frames} frames, encoder got {meta}, want {want} bytes of {ow}x{oh}")
    edvrCalls = sum(m.calls for m in dcn.edvr)
    if len(dcn.edvr) != 1 or edvrCalls < 2 or launches["deformConv2d"] != 4 * edvrCalls:
        raise AssertionError(f"vsr launched {launches}, EDVR counted {edvrCalls} calls: want 4 DCNs a call")
    if launches["warp"] == 0 or dcn.nan:
        raise AssertionError(f"vsr: {launches['warp']} warp launches, NaN offsets {dcn.nan}")
    emit(phase="vsr", steps=VSR, input=[VSR_FRAMES, VSR_H, VSR_W, 3], frames_read=frames,
         encoded_frames=meta["bytes"] // (ow * oh * 6), geometry=meta["s"], seconds=seconds, launches=launches,
         edvr_calls=edvrCalls, max_abs_offset_by_dcn_level=dcn.maxOffset,
         share_abs_offset_over_3px={lv: sum(v) / len(v) for lv, v in dcn.over3.items()},
         share_abs_offset_under_1px={lv: sum(v) / len(v) for lv, v in dcn.under1.items()})
    return launches["deformConv2d"], dcn.inputs


def vsrStream(opt, collect):
    from moephoto_tpu_torch.models.iconvsr import doVSR
    from moephoto_tpu_torch.progress import Node

    return doVSR(lambda x: None if x is None else [collect(x)], Node({"op": "smoke"}), opt)


def feedClip(opt, frames, collect):
    """A whole clip through a fresh stream, with the reflection padding the
    video engine sets (3 frames at each end): the outputs of every frame."""
    from moephoto_tpu_torch.models.iconvsr import VSROpt

    o = VSROpt()
    o.model, o.dtype, o.start = opt.model, opt.dtype, 3
    f = vsrStream(o, collect)
    out = []
    for fr in frames:
        out += f(fr)
    o.end = -3
    return out + f(None)


def checkVsrCrop(seed):
    """The VSR stream on 9 frames of 128x128, IconVSR at full depth in
    fp32, on the card (kernel path) against the CPU (plain path), same
    weights."""
    from moephoto_tpu_torch.models.iconvsr import getOpt

    frames = np.random.RandomState(seed + 6).rand(9, 128, 128, 3).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        opt = getOpt({}, torch.device(dev), torch.float32)
        resetCounts()
        outs[dev] = torch.stack(feedClip(opt, [torch.from_numpy(f).to(dev) for f in frames], lambda x: x.cpu()))
        launches = readCounts()
        if (dev == "cuda") != (launches["deformConv2d"] > 0 and launches["warp"] > 0):
            raise AssertionError(f"vsr crop on {dev}: {launches}")
    err = (outs["cuda"] - outs["cpu"]).abs()
    tol = VSR_TOL * outs["cpu"].abs().clamp_min(1.0)
    if not (outs["cuda"].shape == (9, 512, 512, 3) and bool((err <= tol).all()) and torch.isfinite(outs["cuda"]).all()):
        raise AssertionError(f"vsr crop: shape {tuple(outs['cuda'].shape)}, card vs CPU {float(err.max())}")
    emit(phase="vsr_crop", shape=list(outs["cuda"].shape), max_abs_err=float(err.max()),
         tol=f"{VSR_TOL}*max(1,|cpu|)")


def timingVsr(seed, gpu, pathInputs):
    """Input Mpx/s of whole 22-frame clips on device-resident 640x360
    frames (bf16), a profiled clip by kernel name, and K3 at each of its
    three shapes on the inputs the CLI run gave it, beside its bound and
    its plain version."""
    from moephoto_tpu_torch.models.iconvsr import getOpt
    from moephoto_tpu_torch.ops.deform import deformConv2d, deformConv2dPlain

    opt = getOpt({})
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = [torch.rand((VSR_H, VSR_W, 3), generator=g, device="cuda") for _ in range(VSR_FRAMES)]
    clip = lambda: feedClip(opt, frames, lambda x: x.mean())
    clip()  # warm-up: cuDNN's first calls at these shapes
    runs = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        outFrames = len(clip())
        end.record()
        torch.cuda.synchronize()
        runs.append({"seconds_wall": time.perf_counter() - t0, "seconds_events": start.elapsed_time(end) / 1e3,
                     "output_frames": outFrames})
    resetCounts()
    wallMs, rows = profileOnce(clip)
    launches = readCounts()
    deviceMs = sum(t for _, t in rows)
    dcnMs = sum(t for k, t in rows if isDcnKernel(k))
    warpMs = sum(t for k, t in rows if isWarpKernel(k))
    emit(phase="vsr_timing", gpu=gpu, frames=VSR_FRAMES, runs=runs,
         input_mpx_per_s=[VSR_FRAMES * VSR_H * VSR_W / 1e6 / r["seconds_events"] for r in runs],
         profiled_launches=launches, profiled_wall_ms=wallMs, profiled_device_ms=deviceMs,
         device_ms_per_frame=deviceMs / VSR_FRAMES, dcn_device_ms_per_frame=dcnMs / VSR_FRAMES,
         warp_device_ms_per_frame=warpMs / VSR_FRAMES,
         device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
         top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:16]])

    shapes = {}
    for lv in ("l3", "l2", "l1", "cas"):
        x, off, mask, weight, bias, dg = pathInputs[lv]
        kernelMs = sum(t for k, t in profileOnce(
            lambda: [deformConv2d(x, off, mask, weight, bias, dg) for _ in range(ITERS)])[1] if isDcnKernel(k)) / ITERS
        wrapperMs = cudaTimeMs(lambda: deformConv2d(x, off, mask, weight, bias, dg), ITERS)
        plainMs = cudaTimeMs(lambda: deformConv2dPlain(x, off, mask, weight, bias, dg), 2)
        bound, boundBy = dcnBound(x, off, mask, weight.shape[0])
        shapes[lv] = dict(shape=list(x.shape), dtype=str(x.dtype)[6:], offset_dtype=str(off.dtype)[6:],
                          offset_strides=list(off.stride()), ms=kernelMs, wrapper_ms=wrapperMs, plain_ms=plainMs,
                          bound_ms=bound, bound_by=boundBy, library_ms=None)
    emit(phase="kernel_timing", gpu=gpu, kernel="deformConv2d", by_level=shapes,
         library="none: no single PyTorch call computes DCNv2 (torchvision is absent)")
    return shapes["l1"]


def checkLutClamped(seed):
    """ailutTransformClamped (K5) against ailutTransformClampedPlain on the
    card: NaN exactly where the plain version is NaN, every other value
    within the tolerance (bit-equal is expected, as for K4)."""
    from moephoto_tpu_torch.ops.lut import ailutTransformClamped, ailutTransformClampedPlain, clampRange

    shifted = ((0.05, 0.9), (0.0, 1.0), (0.1, 0.95))  # common range [0.1, 0.9]
    unit = ((0.0, 1.0),) * 3
    cases = {  # B, h, w, image range, channel vertex ranges, NaN pixels
        "1080p_in_range": (1, H, W, 0.0, 1.0, unit, False),
        "1080p_clamped_differing_ranges": (1, H, W, -0.4, 1.5, shifted, False),
        "B2_ragged_37x1001_nan": (2, 37, 1001, -0.2, 1.2, shifted, True),
        "disjoint_ranges_33x99": (1, 33, 99, -0.4, 1.5, ((0.6, 1.0), (0.0, 1.0), (0.0, 0.4)), False),
    }
    errs, clamped = {}, {}
    for i, (name, (B, h, w, lo, hi, ranges, nan)) in enumerate(cases.items()):
        img, lut, vertices = lutCase(seed + 90 + i, B, h, w, lo, hi)
        a = torch.tensor([r[0] for r in ranges], device="cuda")[None, :, None]
        b = torch.tensor([r[1] for r in ranges], device="cuda")[None, :, None]
        vertices = (a + (b - a) * vertices).contiguous()
        if nan:
            img[:, ::5, ::7, 1] = float("nan")
        vlo, vhi = (t.reshape(-1, 1, 1, 1) for t in clampRange(vertices))
        if name.startswith("disjoint") != bool((vlo > vhi).all()):
            raise AssertionError(f"{name}: lo {vlo.flatten().tolist()}, hi {vhi.flatten().tolist()}")
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            got = ailutTransformClamped(x, lut, vertices)
            want = ailutTransformClampedPlain(x, lut, vertices)
            torch.cuda.synchronize()
            isNan = torch.isnan(want)
            key = f"{name}_{str(dtype)[6:]}"
            if not torch.equal(torch.isnan(got), isNan) or bool(isNan.any()) != nan:
                raise AssertionError(f"ailutTransformClamped NaNs differ from its plain version: {key}")
            got, want = got.float()[~isNan], want.float()[~isNan]
            diff = (got - want).abs()
            tol = LUT_TOL * want.abs().clamp_min(1.0)
            if dtype == torch.bfloat16:  # a sum near a rounding boundary may round the other way
                tol = tol + 2.0**-7 * want.abs()
            errs[key] = float(diff.max())
            if not bool((diff <= tol).all()):
                raise AssertionError(f"ailutTransformClamped disagrees with its plain version: {key} max {errs[key]}")
        clamped[name] = float(((img < vlo) | (img > vhi)).float().mean())
        del img, lut, vertices, got, want, diff
    emit(phase="kernels", kernel="ailutTransformClamped", fp32_tol=f"{LUT_TOL}*max(1,|plain|)",
         bf16_tol=f"{LUT_TOL}*max(1,|plain|)+2^-7*|plain|", max_abs_err=errs, share_clamped=clamped)
    return max(v for k, v in errs.items() if k.endswith("float32"))


def runParity():
    """The kernel parity gate, as a user runs it: every kernel launched on
    the gate's cases and held against its plain version."""
    from moephoto_tpu_torch.tools import chipparity

    resetCounts()
    t0 = time.perf_counter()
    results = chipparity.runAll()
    seconds = time.perf_counter() - t0
    launches = readCounts()
    chipparity.assertAll(results)
    want = {"fusedUpHeads": 1, "ailutTransform": 1, "warp": 2, "deformConv2d": 1, "ailutTransformClamped": 1}
    if launches != want or len(results) != 6:
        raise AssertionError(f"parity gate launched {launches}, want {want}; keys {list(results)}")
    emit(phase="parity", max_abs_err=results, tolerances=chipparity.TOLERANCES, launches=launches, seconds=seconds)
    return launches["ailutTransformClamped"], results["ailutTransformPallas"]


def runImageChain(name, steps, size, outSize, seed, work, wantK1):
    """One ``cli image`` run on the card in bf16, PNG to PNG."""
    from PIL import Image

    from moephoto_tpu_torch import cli

    w, h = size
    src, dst = os.path.join(work, f"{name}_in.png"), os.path.join(work, f"{name}_out.png")
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)).save(src)
    resetCounts()
    t0 = time.perf_counter()
    cli.runImage(src, dst, steps)
    seconds = time.perf_counter() - t0
    launches = readCounts()
    with Image.open(dst) as out:
        got, mode = out.size, out.mode
        arr = np.asarray(out)
    if got != outSize or mode != "RGB" or not arr.std() > 0:
        raise AssertionError(f"{name}: output {got} {mode} std {arr.std()}, want {outSize} RGB")
    if launches["fusedUpHeads"] != wantK1 or sum(launches.values()) != wantK1:
        raise AssertionError(f"{name} launched {launches}, want {wantK1} fusedUpHeads and nothing else")
    emit(phase=name, steps=steps, input=[h, w, 3], output=list(arr.shape), seconds=seconds, launches=launches,
         output_mean=float(arr.mean()), output_std=float(arr.std()))
    return launches["fusedUpHeads"]


def checkDnCrop(seed):
    """A 128x128 crop through ModelExec for NetDN, SEDN and MyNet x2, and
    the three resize methods on a 270x480 image, on the card in fp32
    against the CPU, same weights."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.models import api, sr
    from moephoto_tpu_torch.pipeline.registry import DN_REGISTRY, SR_REGISTRY
    from moephoto_tpu_torch.synth import synthMyNetParams, synthNetDNParams, synthSEDNParams

    x = torch.from_numpy(np.random.RandomState(seed + 7).rand(128, 128, 3).astype(np.float32))
    report = {}
    for name, make, sd, entry in (("netDN", sr.netDN, synthNetDNParams(seed), DN_REGISTRY["lite5"]),
                                  ("sedn", sr.sedn, synthSEDNParams(seed), DN_REGISTRY["15"]),
                                  ("net2x", sr.net2x, synthMyNetParams(2, seed), SR_REGISTRY["a2"])):
        outs = []
        for dev in ("cuda", "cpu"):
            model = make()
            model.load_state_dict(sd, strict=True)
            ex = ModelExec(model.to(dev).eval(), entry["spec"], channelSplit=True, dtype=torch.float32, device=dev)
            outs.append(ex(x).cpu())
        err = (outs[0] - outs[1]).abs()
        if not (bool((err <= DN_CROP_TOL * outs[1].abs().clamp_min(1.0)).all()) and torch.isfinite(outs[0]).all()):
            raise AssertionError(f"{name} crop on the card differs from the CPU by {float(err.max())}")
        report[name] = {"shape": list(outs[0].shape), "max_abs_err": float(err.max()),
                        "cpu_std": float(outs[1].std())}
    y = torch.from_numpy(np.random.RandomState(seed + 8).rand(1, 270, 480, 3).astype(np.float32))
    resizes = {}
    for name, fn in (("bilinear", api.resizeBilinear), ("nearest", api.resizeNearest), ("bicubic", api.resizeCubic)):
        for h, w in ((405, 720), (181, 321)):
            err = float((fn(y.cuda(), h, w).cpu() - fn(y, h, w)).abs().max())
            if not err <= RESIZE_TOL:
                raise AssertionError(f"resize {name} to {h}x{w} on the card differs from the CPU by {err}")
            resizes[f"{name}_{h}x{w}"] = err
    emit(phase="dn_crop", tol=f"{DN_CROP_TOL}*max(1,|cpu|)", models=report, resize_tol=RESIZE_TOL, resizes=resizes)


def timingDn(seed, gpu):
    """Mpx/s of DN lite5, DN 15 (SEDN), SR a x2 and the DN lite5 -> SR lite
    x4 chain on a device-resident 1080p image (bf16, CUDA events after
    warm-up), each with one profiled call; then K5 alone at 1080p and at
    the parity gate's 32x64, beside its plain version and its bound."""
    from moephoto_tpu_torch.ops.lut import ailutTransformClamped, ailutTransformClampedPlain
    from moephoto_tpu_torch.pipeline import registry

    dn = registry.getDN({"model": "lite5"})  # built by the CLI runs
    sedn = registry.getDN({"model": "15"})
    a2 = registry.getSR({"model": "a", "scale": 2})
    lite4 = registry.getSR({"model": "lite", "scale": UPSCALE})
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((H, W, 3), generator=g, device="cuda")
    paths = {"DN_lite5": (lambda: dn(x), ITERS), "DN_15_sedn": (lambda: sedn(x), 3), "SR_a_x2": (lambda: a2(x), ITERS),
             "chain_DN_lite5_SR_lite_x4": (lambda: lite4(dn(x)), ITERS)}
    report = {}
    for name, (fn, iters) in paths.items():
        for _ in range(WARMUP):
            fn()
        ms = cudaTimeMs(fn, iters)
        resetCounts()
        wallMs, rows = profileOnce(fn)
        deviceMs = sum(t for _, t in rows)
        report[name] = {"mpx_per_s": (H * W / 1e6) / (ms / 1e3), "ms_per_image": ms, "iters": iters,
                        "profiled_wall_ms": wallMs, "profiled_device_ms": deviceMs,
                        "device_idle_share": (1 - deviceMs / wallMs) if wallMs else None,
                        "profiled_launches": {k: v for k, v in readCounts().items() if v},
                        "top_kernels": [{"name": k[:80], "ms": t} for k, t in rows[:8]]}
    emit(phase="dn_timing", gpu=gpu, input=[H, W, 3], dtype="bfloat16", warmup=WARMUP, paths=report)

    shapes = {}
    for name, (h, w) in (("gate_32x64", (32, 64)), ("1080p", (H, W))):
        img, lut, vertices = lutCase(seed + 95, 1, h, w, -0.4, 1.5)
        vertices = (0.1 + 0.8 * vertices).contiguous()  # common range [0.1, 0.9]: the clamp bites
        wrapperMs = cudaTimeMs(lambda: ailutTransformClamped(img, lut, vertices), ITERS)
        plainMs = cudaTimeMs(lambda: ailutTransformClampedPlain(img, lut, vertices), 3)
        _, rows = profileOnce(lambda: [ailutTransformClamped(img, lut, vertices) for _ in range(ITERS)])
        kMs = sum(t for k, t in rows if "ailutKernel" in k) / ITERS
        bound, boundBy = lutBound(img, lut, vertices)
        shapes[name] = dict(shape=list(img.shape), ms=kMs, wrapper_ms=wrapperMs, plain_ms=plainMs, bound_ms=bound,
                            bound_by=boundBy, gbytes_per_s=(2 * img.numel() * 4) / (kMs / 1e3) / 1e9)
    emit(phase="kernel_timing", gpu=gpu, kernel="ailutTransformClamped", D=33, by_shape=shapes,
         library="none: F.grid_sample samples uniform grids only")
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.models.iconvsr import modelPath_ as vsrPath
    from moephoto_tpu_torch.ops import _build, deform, fusedup, lut, warp
    from moephoto_tpu_torch.engine.tiling import planAxis
    from moephoto_tpu_torch.pipeline.registry import SR_REGISTRY
    from moephoto_tpu_torch.synth import (synthAiLUTParams, synthAODParams, synthIconVSRParams, synthIFRNetParams,
                                          synthLite2Params, synthMyNetParams, synthNetDNParams, synthSEDNParams,
                                          synthSunParams)

    # fp32 comparisons run in true fp32: cuDNN would run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    sources = (fusedup.SOURCE, lut.SOURCE, warp.SOURCE, deform.SOURCE)
    _build.loadAll(sources)
    emit(phase="build", seconds=time.perf_counter() - t0, libraries={src: {
        "nvcc_seconds": _build.buildInfo[src]["seconds"],
        "library": os.path.relpath(_build.libraryPath(src), ROOT),
        "ptxas": [ln.strip() for ln in _build.buildInfo[src]["log"].splitlines()
                  if "registers" in ln or "spill" in ln]} for src in sources})

    errs = checkKernel(args.seed)
    lutErr = checkLut(args.seed)
    warpErr = checkWarp(args.seed)
    dcnErr = checkDcn(args.seed)
    clampErr = checkLutClamped(args.seed)
    clampLaunches, clampGateErr = runParity()

    def liteLaunches(w, h, scale):  # fusedUpHeads launches of one lite image: its tile chunks
        spec = SR_REGISTRY[f"lite{scale}"]["spec"]
        tiles = len(planAxis(h, spec.tile, spec.pad)) * len(planAxis(w, spec.tile, spec.pad))
        return -(-tiles // spec.batch)

    config.device, config.bf16 = "cuda", True
    with tempfile.TemporaryDirectory() as work:
        for sub, name, sd in (("lite", "model_4.pth", synthLite2Params(UPSCALE, args.seed)),
                              ("demoire", "sun_epoch_200.pth", synthSunParams(args.seed)),
                              ("dehaze", "AOD_net_epoch_relu_10.pth", synthAODParams(args.seed)),
                              ("AiLUT", "AiLUT-FiveK-sRGB.pth", synthAiLUTParams("tpami", 3, args.seed)),
                              ("IFRNet", "IFRNet_GoPro.pth", synthIFRNetParams("M", args.seed)),
                              ("vsr", os.path.basename(vsrPath), synthIconVSRParams(args.seed, VSR_BLOCKS)),
                              ("lite", "model.pth", synthLite2Params(2, args.seed)),
                              ("dn_lite5", "model_new.pth", synthNetDNParams(args.seed)),
                              ("l15", "model_new.pth", synthSEDNParams(args.seed)),
                              ("a2", "model_new.pth", synthMyNetParams(2, args.seed))):
            os.makedirs(os.path.join(work, sub), exist_ok=True)
            torch.save(sd, os.path.join(work, sub, name))
        config.modelDir, config.opsPath, config.ffmpegPath = work, os.path.join(work, "ops.json"), fakeFfmpeg(work)
        launches = runMainPath(args.seed, work)
        checkCrop(args.seed)
        lutLaunches, lutInput, lutModel = runRetouch(args.seed, work)
        checkRetouchCrop(args.seed)
        checkGenerate(args.seed)
        kt = timing(args.seed, smi)
        lt = timingRetouch(args.seed, smi, lutInput, lutModel)
        warpLaunches, pathInputs = runVideo(work)
        checkVideoCrop(args.seed)
        wt = timingSlomo(args.seed, smi, pathInputs)
        dcnLaunches, dcnInputs = runVsr(work)
        checkVsrCrop(args.seed)
        dt = timingVsr(args.seed, smi, dcnInputs)
        runImageChain("dn_chain", DN_CHAIN, (W, H), (W * UPSCALE, H * UPSCALE), args.seed + 9, work,
                      liteLaunches(W, H, UPSCALE))
        runImageChain("preset", PRESET, (PRESET_W, PRESET_H), (2 * PRESET_W, 2 * PRESET_H), args.seed + 10, work,
                      liteLaunches(PRESET_W, PRESET_H, 2))
        checkDnCrop(args.seed)
        ct = timingDn(args.seed, smi)

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
    }, {
        "name": "warp", "route": "cuda", "source": "moephoto_tpu_torch/csrc/warp.cu",
        "replaces": "moephoto_tpu/ops/warp.py:170", "launches": warpLaunches,
        "max_abs_err": warpErr, "ms": wt["ms"], "plain_ms": wt["plain_ms"],
        "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"], "library_ms": wt["library_ms"],
    }, {
        "name": "deformConv2d", "route": "cuda", "source": "moephoto_tpu_torch/csrc/dcn.cu",
        "replaces": "moephoto_tpu/ops/dcnkernel.py:184", "launches": dcnLaunches,
        "max_abs_err": dcnErr, "ms": dt["ms"], "plain_ms": dt["plain_ms"],
        "bound_ms": dt["bound_ms"], "bound_by": dt["bound_by"], "library_ms": None,
    }, {  # launched by the parity gate only; timed at the gate's shape, and at 1080p beside it
        "name": "ailutTransformClamped", "route": "cuda", "source": "moephoto_tpu_torch/csrc/ailut.cu",
        "replaces": "moephoto_tpu/ops/lutkernel.py:322", "launches": clampLaunches,
        "max_abs_err": max(clampErr, clampGateErr), "ms": ct["gate_32x64"]["ms"],
        "plain_ms": ct["gate_32x64"]["plain_ms"], "bound_ms": ct["gate_32x64"]["bound_ms"],
        "bound_by": ct["gate_32x64"]["bound_by"], "library_ms": None,
        "ms_1080p": ct["1080p"]["ms"], "plain_ms_1080p": ct["1080p"]["plain_ms"],
        "bound_ms_1080p": ct["1080p"]["bound_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
