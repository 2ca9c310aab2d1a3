"""GPU smoke test of the PyTorch/CUDA port (moephoto_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    builds every CUDA kernel of the main paths from csrc/, one
              nvcc per source, all started together
  3. kernels  holds each kernel against its plain PyTorch version on the
              card at the main paths' shapes: fusedUpHeads in fp32 (TF32
              off) and bf16, with ragged row counts around the tensor-core
              tiles, c = 96 with nUps 1 to 3, a width that is no multiple
              of 16, two planes with per-channel slopes and inputs x8, and
              which instance (wgmma at c = 48, mma.sync at c = 96, CUDA
              cores) each case launched; ailutTransform (K4) at 1080p in
              range and out of range, B = 2 and 3 with ragged pixel counts,
              values on every vertex, fewer pixels than a block, D = 17, 48
              and 64, fp32 and bf16; warp at IFRNet-M's four 1080p
              warp shapes, a ragged shape, B = 2 and a stride-0 batch,
              both padding modes, fp32 and bf16, flows up to 40 px, 1e6
              and NaN, and backWarp against its plain fold; the DCNv2
              sampler (K3) at EDVR's three 640x360 shapes in bf16 and
              fp32 (TF32 off), ragged shapes and tiles, less than one
              tile, dg 4, 6 and 8, B = 1, Cout 96 and 128, C = 128,
              16-byte and scalar corner loads, offsets up to 40 px, 1e6
              and NaN, offsets and mask read as strided slices of one
              conv output, and which instance (tensor cores, CUDA cores)
              each case launched; ailutTransformClamped (K5) at 1080p in
              and out of range with differing channel ranges, B = 2 and 3
              ragged, NaN pixels, disjoint ranges (lo > hi), values on
              every vertex, fewer pixels than a block, D = 17, 48 and 64,
              fp32 and bf16
     blend    the engine's chunk blend (K7, blendTiles) bit-equal to its
              plain loop (blendTilesPlain, the engine's blend before K7)
              on the card, canvas and weight, on lite x4's 1080p plan (4
              chunks of 10 channel-split bf16 tiles of 1024x1024x3) and
              two small plans (1 x 1 and 3 x 4 tiles), one launch a
              chunk; its time beside its byte bound and the plain loop's;
              a 1080p lite x4 image through ModelExec with K7 and with
              the plain loop, in turns; blend_uploads 1, 0, 0 on three
              profiled images after the ramp cache is emptied; a warm
              image under set_sync_debug_mode("error") raises nothing,
              the plain loop's window copies raise
     layernorm NAFNet's channels-last LayerNorm (K8, ops/layernorm.py)
              against its plain versions on the card, both modes (the
              norm; the scaled residual z bit-equal, then its norm),
              fp32 and bf16, C = 32 to 1024, ragged row counts, within one
              bf16 ulp (fp32 1e-5); its time at the NAFNet cell's five
              level shapes (a chunk of four 256x256 tiles) in both modes,
              each call after an L2 flush, beside its byte bound and the
              plain version's time, and F.layer_norm's beside mode (a) (the
              library yardstick)
     parity   the kernel parity gate (tools/chipparity.py runAll and
              assertAll): five kernels against their plain versions on
              the JAX gate's six cases, each launched once
  4. main     runs the CLI's image SR path (MoeNet_lite2 x4, bf16) on a
              seeded 1920x1080 PNG with seeded random weights, checks the
              7680x4320 output and the kernel launch counts (4 K1, 4 K7),
              and holds a
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
              same for each retouch step and the chain; then K4 and K5 at
              1080p on the chain's AiLUT input, a smooth image, a constant
              one and random colours, each launch timed apart, back to
              back and after L2 is flushed, beside an image copy's time
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
              version and F.grid_sample (and on incoherent 40 px flows);
              then holds the output path on the card (quantise there,
              the integers copied into page-locked memory) bit-equal to
              the host path it replaced on two 1080p lite x4 outputs at
              8 bits and on 1080p IFRNet-M slomo frames at 16 bits with
              the channel flip, each path timed warm, the first image's
              array unchanged after the second; then holds the input
              path on the card (the integers uploaded and widened there)
              bit-equal to the host conversion it replaced on the 256
              byte values, the 65536 16-bit values and a 1080p image,
              both paths timed warm
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
  9. demob    runs the CLI's video path with ESTRNN 1ms8ms deblur (fake
              ffmpeg decode -> buffer -> demob in bf16 -> output -> encode) on
              9 1280x720 frames with seeded random weights (the last conv
              scaled, DEMOB_OUT_GAIN), checks 9 encoded frames and no kernel
              launch; then BASELINE config 5, demob -> IFRNet-M slomo x2
              (bench.py runs IFRNet S), 17 encoded frames and 64 warp
              launches; holds the deblur stream on 6 frames of 128x128 in
              fp32 on the card against the CPU; times ESTRNN at 1280x720 on
              device-resident frames (output Mpx/s and device ms a frame by
              CUDA events, a profiled chunk: idle share, top kernels)
 10. dn       runs the CLI's image path on the denoise -> SR chain (DN
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
              K5 alone at 1080p and at the gate's 32x64, timed as above
 11. zoo      runs BASELINE config 3 through the CLI's image path (DN
              MPRNet_denoising -> DN NAFNet_32, bf16, full width) on a seeded
              1920x1080 PNG, checks the output and that no hand-written kernel
              but the engine's K7 and NAFNet's K8 launched (K8 at least
              once), counts 864 K8 kernels and no ATen layer norm in a
              trace of one 1080p image through the CLI's own NAFNet_32 exec
              (its stage graphs replayed), and holds a 128x128 crop of each
              model in fp32 on the card against the CPU; then every other
              model of the zoo once through its registry entry's ModelExec
              on the card in bf16 (NAFNet_64, the three NAFNet deblur
              entries, MPRNet deblurring and deraining and moire_obj on
              1280x720; gan2, gan4, gana4 and VSR_Cleaning on 640x360;
              moire_screen_gan on 1920x1080), each output finite and of its
              size, K8 launched by the NAFNet entries and by no other,
              with its fp32 crop against the CPU; then times NAFNet-32, MPRNet deblurring, the config-3
              chain, moire_obj and moire_screen_gan at 1080p and gan4 at
              640x360 on a device-resident image (input Mpx/s by CUDA events,
              multiply-accumulates an image counted on the meta device, one
              profiled call: device ms, idle share, top kernels)
 12. mesh     the multi-device serving layer on the one card, row shards of
              cuda:0 x 2 and x 4 (installed meshes): K2a (warpSpmd,
              backWarpSpmd), K3's tier (deformConv2dSpmd) and K6
              (ailutTransformSpmd) held bit-equal to the single-device
              kernels on the inputs the video, vsr and retouch phases
              recorded (backWarpSpmd on IconVSR's SpyNet levels and
              propWarp, also with its scan's reach passed as ``reach``),
              flows that span shards included; cli image lite x4
              on the main phase's PNG under [2] (within 1 LSB of its output,
              K1 launched by each mesh slot); cli video IFRNet-M slomo x2 on
              the video phase's 9 frames under [2] and [4] (17 frames, each
              within 1 LSB of the video phase's, K2a launches, gathered
              segments and host reads counted), and on 5 frames at
              3840x2160 under [2] and [4] against a single-device run
              there (9 frames, the same bound), where IFRNet's 1/8 level
              runs sharded; the 128x128 slomo crop in
              fp32 against the single-device card run; cli video IconVSR x4
              on the vsr phase's 22 frames of 640x360 and ESTRNN on the demob
              phase's 9 frames of 1280x720 under [2] and [4] (every stage
              row-sharded: EDVR's four DCNs through K3's tier, SpyNet's and
              the recurrences' warps through K2a; each frame within 1 LSB of
              the single-device run, launches, gathered segments and host
              reads counted, every segment run sharded also run whole and
              bit-equal to it), their fp32 128x128 crops on [2] against the
              single-device card run; AiLUT under spmdTracing() (K6); then
              slomo and lite x4 Mpx/s sharded against single-device, the
              halo exchange's ms per stage, each sharded kernel's per-shard
              median launch beside its bound (K2a, at IFRNet's and
              IconVSR's shapes, beside F.grid_sample on each shard's halo
              window), and VSR and demob Mpx/s sharded
              against single-device
 13. server   the product surface: ``python3 app_torch.py`` started in a
              fresh working directory (its two processes, pipes and
              shared-memory block) with the synth weights above, then over
              127.0.0.1: /systemInfo (free MiB of the one card), the main
              phase's 1080p PNG through /image_enhance lite x4 twice (each
              within 1 LSB of its output; a /msg long-poll beside the first
              returns progress notes), /batch_enhance of two 480x270 PNGs (2
              done, 0 failed), /video_enhance IFRNet-M slomo x2 on the fake
              ffmpeg's 9 frames (17 frames, each within 1 LSB of the video
              phase's), lockInterface ended by /stop (Interrupted, within
              5 s), a malformed /image_enhance (400, Fail) and a request
              served after it; SIGINT, and no process and no shared-memory
              block left; then the same server and worker() loop in this
              process (threads, real pipes and shared memory) for one image
              and one video request: 4 fusedUpHeads and 64 warp launches,
              outputs within 1 LSB of the app's, each request's time split
              into upload, worker (PNG decode and encode apart) and reply
 14. train    training (parallel/sharded.py's train steps, tools/train.py,
              tools/dryrun.py), lite x2 at full width and the CLI's batch 8
              of 64 px patches: one fp32 SGD step on the card (TF32 off)
              against the CPU, loss and gradient, on [1, 1] and on
              cuda:0 x [2, 2] against cpu x [2, 2]; the fine-tuning CLI on
              the card from scratch in bf16 on seeded structured images,
              the held-out PSNR gaining at least 3 dB, then resumed from
              its checkpoint (no hand-written kernel launched); the trained
              state dict in the inference module on a 1080p plane, K1
              against the plain up path in fp32 and bf16, after the module
              had prepared K1's weights for the seeded ones (4 K1
              launches); dryrunMultichip(8) on the cards (cuda:0 x 8 on one),
              its shapes and devices
     train_timing  Adam steps in fp32 and bf16 on [1, 1] and cuda:0 x
              [2, 2] at the CLI's defaults and at batch 32 of 128 px on
              [1, 1]: the median step by CUDA events, LR Mpx/s, FLOP a step
              (FlopCounterMode), TFLOP/s, peak memory, one profiled step's
              idle share and top kernels
 15. deploy   the deployment tools (tools/export.py, package.py,
              calibrate.py): lite4 at its 1080p tile shape (256x256, bf16)
              and AiLUT_sRGB_3 at 1080p (fp32) exported with torch.export on
              the card, one moephoto_torch op node each (K1, K4), each
              loaded in a fresh process through loadExported and held
              bit-equal to the eager module on a seeded input, K1 and K4
              launched there; the packager with --models lite4 into the work
              directory (six prebuilt kernel libraries under build/), the
              tree's cli image lite x4 on the main phase's PNG from its root
              with nvcc off PATH and CUDA_HOME missing, 0 LSB from the main
              phase and no new build file; calibrate lite4 at 1080p over
              tiles 192/256/384 x batches 2/4/8 (Mpx/s, peak MiB, best);
              the main path's Mpx/s and K1's and K4's ms beside PERF.md's, and
              the host microseconds the registered ops add to a launch (K1
              at 64 rows, K4 at 8x8, op against the direct launch, in turns)
Each phase's seconds go into a ``phase_seconds`` line.
Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero without that last line; with no CUDA device it
exits 1 before doing anything.
"""

import argparse
import dataclasses
import glob
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
L2_FLUSH_BYTES = 256 << 20  # written between timed AiLUT calls: five times the card's 50 MB of L2
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
DEMOB = [{"op": "demob", "model": "1ms8ms"}]
CONFIG5 = DEMOB + SLOMO  # BASELINE config 5: ESTRNN deblur, then IFRNet slomo x2 (bench.py:750-870)
DEMOB_W, DEMOB_H, DEMOB_FRAMES = 1280, 720, 9
# the seeded random ESTRNN's last conv scaled by this and its bias raised by 0.5, so its
# outputs spread over about [0.14, 0.82] instead of 0.50 +- 0.01 (the 16-bit comparisons
# then see every value; the draws stay synth.synthESTRNNParams')
DEMOB_OUT_GAIN = 30.0
# ESTRNN stream on the card vs the CPU, fp32, relative to max(1, |cpu|): cuDNN's conv
# algorithms differ from the CPU's by ~1e-5 a layer over the ~60 convs of a recurrence
# step and the recurrence; no looser than VSR_TOL
DEMOB_TOL = 1e-3
DEMOB_WARM, DEMOB_TIMED = 16, 48  # frames of the 720p timing (bench.py:556 times 72 after 24)
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
    device time, and so do the device spans of annotated regions (an
    optimizer's ``step``); counting both would count it twice."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wallMs = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
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


def upCase(ups, pack, M, dtype, seed, scale=1.0):
    from moephoto_tpu_torch.models.api import packBlockDiag
    from moephoto_tpu_torch.synth import synthLite2Params

    sd = synthLite2Params(ups, seed)
    if pack > 1:
        sd = packBlockDiag(sd, pack)
    params = {k: v.to("cuda", dtype) for k, v in sd.items()}
    g = torch.Generator(device="cuda").manual_seed(seed + M)
    c = 48 * pack
    res = (torch.randn((M, c), generator=g, device="cuda") * scale).to(dtype)
    im = (torch.randn((M, c), generator=g, device="cuda") * scale).to(dtype)
    return params, res, im, int(ups).bit_length() - 1


def upHandCase(c, nUps, cout, M, dtype, seed):
    """Up-path parameters built by hand at any width: weights at
    1/sqrt(c), per-channel PReLU slopes in [-0.5, 1.5), cout head rows."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for br in ("ures", "uim"):
        for i in range(nUps):
            sd[f"{br}.{i}.0.weight"] = torch.randn((4 * c, c, 1, 1), generator=g) / c**0.5
            sd[f"{br}.{i}.0.bias"] = torch.randn((4 * c,), generator=g) * 0.1
            sd[f"{br}.{i}.2.weight"] = torch.rand((c,), generator=g) * 2 - 0.5
    for head in ("convt_R1", "convt_I1"):
        sd[head + ".weight"] = torch.randn((cout, c, 1, 1), generator=g) / c**0.5
    params = {k: v.to("cuda", dtype) for k, v in sd.items()}
    rows = [torch.randn((M, c), generator=g).to("cuda", dtype) for _ in range(2)]
    return params, rows[0], rows[1], nUps


def checkKernel(seed):
    """fusedUpHeads against fusedUpHeadsPlain on the card; which instance
    each case launched is printed beside its error."""
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads, fusedUpHeadsPlain, instanceVariant

    mainM = 10 * 3 * 256 * 256  # one x4 chunk: 10 tiles x 3 planes x 256^2 rows
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(lambda u=u, p=p, M=M, d=d: upCase(u, p, M, d, seed), f"nUps{int(u).bit_length() - 1}_c{48 * p}_M{M}", d, 1.0)
             for u, p, M in ((4, 1, mainM), (2, 1, 100_003), (8, 1, 50_001), (4, 2, 20_001)) for d in (f32, bf)]
    # ragged row counts around the tensor-core tiles: a warp's 16 rows, a
    # warpgroup's 64, a block's 192, and several waves of 132 blocks plus a rest
    for M in (1, 15, 17, 63, 65, 191, 193, 3 * 132 * 192 + 77):
        cases.append((lambda M=M: upCase(4, 1, M, bf, seed), f"nUps2_c48_M{M}", bf, 1.0))
    for M in (15, 17, 191, 193):
        cases.append((lambda M=M: upCase(4, 2, M, bf, seed), f"nUps2_c96_M{M}", bf, 1.0))
    cases += [
        (lambda: upCase(8, 2, 20_001, bf, seed), "nUps3_c96_M20001", bf, 1.0),
        (lambda: upCase(2, 2, 20_001, bf, seed), "nUps1_c96_M20001", bf, 1.0),
        # inputs x8: PReLU's negative side and large sums; a stage value of
        # size 8 that rounds the other way moves the output by 8 times as much
        (lambda: upCase(4, 1, 300_007, bf, seed, 8.0), "nUps2_c48_M300007_x8", bf, 8.0),
        (lambda: upHandCase(48, 2, 2, 70_001, bf, seed + 1), "hand_nUps2_c48_cout2_slopes_per_channel_M70001", bf, 1.0),
        (lambda: upHandCase(48, 3, 2, 30_001, bf, seed + 2), "hand_nUps3_c48_cout2_slopes_per_channel_M30001", bf, 1.0),
        (lambda: upHandCase(20, 2, 1, 40_003, bf, seed + 3), "hand_nUps2_c20_M40003", bf, 1.0),  # 20 % 16 != 0
        (lambda: upHandCase(96, 1, 3, 10_001, bf, seed + 4), "hand_nUps1_c96_cout3_M10001", bf, 1.0),
    ]
    errs, launched = {}, {}
    for make, name, dtype, scale in cases:
        params, res, im, nUps = make()
        got = fusedUpHeads(params, res, im, nUps).float()
        inst = fusedUpHeads.lastInstance
        want = fusedUpHeadsPlain(params, res, im, nUps).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if dtype == f32:
            ok = bool((diff <= FP32_TOL).all())
        else:
            ok = bool((diff <= BF16_REL * want.abs() + BF16_ABS * scale).all())
        name = f"{name}_{str(dtype)[6:]}"
        errs[name] = float(diff.max())
        launched[name] = instanceVariant(inst, res.shape[1], nUps, got.shape[1] // 4**nUps)
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"fusedUpHeads ({launched[name]}) disagrees with its plain version: {name} "
                                 f"max {errs[name]}")
        del params, res, im, got, want, diff
    want = {"nUps2_c48_M1966080_bfloat16": "wgmma", "nUps2_c48_M1966080_float32": "cuda_core",
            "nUps2_c96_M20001_bfloat16": "mma_weights_from_l1", "nUps1_c96_M20001_bfloat16": "mma_weights_in_smem",
            "hand_nUps2_c20_M40003_bfloat16": "cuda_core", "hand_nUps1_c96_cout3_M10001_bfloat16": "mma_weights_in_smem",
            "hand_nUps3_c48_cout2_slopes_per_channel_M30001_bfloat16": "wgmma"}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"fusedUpHeads launched {launched}, want {want}")
    emit(phase="kernels", kernel="fusedUpHeads", fp32_tol=FP32_TOL,
         bf16_tol=f"{BF16_REL}*|plain|+{BF16_ABS}*input_scale", max_abs_err=errs, instance=launched)
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
    with Image.open(dst) as out:
        size, mode = out.size, out.mode
        arr = np.asarray(out)
    if size != (W * UPSCALE, H * UPSCALE) or mode != "RGB":
        raise AssertionError(f"output {size} {mode}, want {(W * UPSCALE, H * UPSCALE)} RGB")
    if counts["fusedUpHeads"] != 4 or counts["blendTiles"] != 4:  # 40 tiles of 256 px in chunks of 10
        raise AssertionError(f"the main path launched {counts}: want 4 fusedUpHeads and 4 blendTiles")
    emit(phase="main", steps=STEPS, input=[H, W, 3], output=list(arr.shape), seconds=seconds,
         dtype=str(config.dtype()), launches=counts,
         output_mean=float(arr.mean()), output_std=float(arr.std()))
    return counts


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

    from moephoto_tpu_torch.ops.fusedup import prepare

    params, res, im, nUps = upCase(UPSCALE, 1, 10 * 3 * 256 * 256, torch.bfloat16, seed)
    M = res.shape[0]
    # as the model calls it: weights prepared once; then with the preparation in every call
    ready = {inst: prepare(params, nUps, torch.bfloat16, "cuda", inst) for inst in ("wgmma", "cuda_core")}
    ms = cudaTimeMs(lambda: fusedUpHeads(ready["wgmma"], res, im, nUps), ITERS)
    msUnprepared = cudaTimeMs(lambda: fusedUpHeads(params, res, im, nUps), ITERS)
    msOld = cudaTimeMs(lambda: fusedUpHeads(ready["cuda_core"], res, im, nUps), 3)
    ms2 = cudaTimeMs(lambda: fusedUpHeads(ready["wgmma"], res, im, nUps), ITERS)
    plainMs = cudaTimeMs(lambda: fusedUpHeadsPlain(params, res, im, nUps), 3)
    bound, boundBy = upBound(M, 48, nUps, 1, 2, PEAK_BF16_FLOPS)
    flop = 2 * (M * 2 * 20 * 48 * 48 + M * 16 * 2 * 48)
    if not bound <= min(ms, ms2):
        raise AssertionError(f"fusedUpHeads took {ms} ms, under its bound of {bound} ms: the count or the window is wrong")
    p32, r32, i32, _ = upCase(UPSCALE, 1, 10 * 3 * 256 * 256, torch.float32, seed)
    ms32 = cudaTimeMs(lambda: fusedUpHeads(p32, r32, i32, nUps), ITERS)
    bound32, _ = upBound(M, 48, nUps, 1, 4, PEAK_FP32_FLOPS)
    emit(phase="kernel_timing", gpu=gpu, kernel="fusedUpHeads", M=M, c=48, nUps=nUps,
         bf16_ms=ms, bf16_ms_again=ms2, bf16_ms_weights_prepared_in_call=msUnprepared, variant="wgmma",
         bf16_cuda_core_ms=msOld, bf16_plain_ms=plainMs, bf16_bound_ms=bound,
         bound_by=boundBy, bf16_tflops=flop / (ms * 1e-3) / 1e12, bf16_share_of_bound=bound / ms,
         fp32_ms=ms32, fp32_variant="cuda_core", fp32_bound_ms_cuda_cores=bound32)
    return dict(ms=ms, plain_ms=plainMs, bound_ms=bound, bound_by=boundBy, variant="wgmma",
                mpx_per_s=(H * W / 1e6) / (msImage / 1e3))


def resetCounts():
    from moephoto_tpu_torch.ops import deform
    from moephoto_tpu_torch.ops.blend import blendTiles
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.layernorm import layerNorm
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformClamped
    from moephoto_tpu_torch.ops.warp import warp

    fusedUpHeads.launches = ailutTransform.launches = warp.launches = deform.deformConv2d.launches = 0
    ailutTransformClamped.launches = blendTiles.launches = layerNorm.launches = 0


def readCounts():
    from moephoto_tpu_torch.ops import deform
    from moephoto_tpu_torch.ops.blend import blendTiles
    from moephoto_tpu_torch.ops.fusedup import fusedUpHeads
    from moephoto_tpu_torch.ops.layernorm import layerNorm
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformClamped
    from moephoto_tpu_torch.ops.warp import warp

    return {"fusedUpHeads": fusedUpHeads.launches, "ailutTransform": ailutTransform.launches,
            "warp": warp.launches, "deformConv2d": deform.deformConv2d.launches,
            "ailutTransformClamped": ailutTransformClamped.launches, "blendTiles": blendTiles.launches,
            "layerNorm": layerNorm.launches}


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


def isLutKernel(name: str) -> bool:
    """The AiLUT lookup kernel (K4 and K5 are its two template instances)."""
    return "ailutKernel" in name


def withVertexTies(case):
    """A third of the pixels exactly on vertices, v[0] .. v[D-1] of each
    channel in turn, in every image: the search's count at its edges."""
    img, lut, vertices = case
    B, h, w, _ = img.shape
    D = vertices.shape[-1]
    img = img.clone().reshape(B, h * w, 3)
    k = torch.arange((h * w) // 3, device="cuda")
    img[:, k, :] = vertices[:, :, k % D].permute(0, 2, 1)
    return img.reshape(B, h, w, 3), lut, vertices


def holdLut(kernel, plain, cases):
    """Each case through ``kernel``, fp32 and bf16, against ``plain``, one
    launch a call: NaN exactly where the plain version has it, fp32 within
    LUT_TOL (relative), bf16 within a rounding of |plain| more.  Returns
    the errors by case and type, and the share of the values outside each
    image's vertex range by case."""
    errs, outside = {}, {}
    for name, make in cases:
        img, lut, vertices = make()
        v0, v1 = vertices[:, None, None, :, 0], vertices[:, None, None, :, -1]
        outside[name] = float(((img < v0) | (img > v1)).float().mean())
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            key = f"{name}_{str(dtype)[6:]}"
            want = plain(x, lut, vertices).float()
            before = kernel.launches
            got = kernel(x, lut, vertices).float()
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{kernel.__name__} {key}: {kernel.launches - before} launches")
            nan = torch.isnan(want)
            if not torch.equal(torch.isnan(got), nan):
                raise AssertionError(f"{kernel.__name__} NaNs differ from its plain version: {key}")
            diff = (got - want).abs()[~nan]
            tol = LUT_TOL * want.abs()[~nan].clamp_min(1.0)
            if dtype == torch.bfloat16:  # a sum near a rounding boundary may round the other way
                tol = tol + 2.0**-7 * want.abs()[~nan]
            errs[key] = float(diff.max()) if diff.numel() else 0.0
            if not (bool((diff <= tol).all()) and bool(torch.isfinite(got[~nan]).all())):
                raise AssertionError(f"{kernel.__name__} disagrees with its plain version: {key} max {errs[key]}")
            del x, want, got, diff
        del img, lut, vertices
    return errs, outside


def checkLut(seed):
    """ailutTransform (K4) against ailutTransformPlain on the card: D = 33
    (every AiLUT model) in and out of range, ragged batches, ties on every
    vertex, less than one block of pixels, D = 17, 48 and 64."""
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformPlain

    def ties():  # every pixel on a vertex: v[0] .. v[D-1] in turn
        img, lut, vertices = lutCase(seed + 13, 1, 33, 99, 0.0, 1.0)
        img = vertices[:, :, None, :].expand(1, 3, 33, 33).permute(0, 2, 3, 1).repeat(1, 1, 3, 1)
        return img.contiguous(), lut, vertices

    cases = [
        ("1080p_in_range", lambda: lutCase(seed + 10, 1, H, W, 0.0, 1.0)),
        ("1080p_extrapolate", lambda: lutCase(seed + 11, 1, H, W, -0.4, 1.5)),
        ("B2_ragged_37x1001", lambda: lutCase(seed + 12, 2, 37, 1001, -0.2, 1.2)),
        ("ties_33x99", ties),
        ("vertex_ties_B2_600x900", lambda: withVertexTies(lutCase(seed + 14, 2, 600, 900, -0.2, 1.2))),
        ("B3_ragged_541x967", lambda: lutCase(seed + 16, 3, 541, 967, -0.4, 1.5)),
        ("below_one_block_17x13", lambda: lutCase(seed + 17, 1, 17, 13, -0.4, 1.5)),
        ("D17_1080p_extrapolate", lambda: lutCase(seed + 18, 1, H, W, -0.4, 1.5, D=17)),
        ("D48_300x400_extrapolate", lambda: lutCase(seed + 19, 1, 300, 400, -0.4, 1.5, D=48)),
        ("D64_1080p_vertex_ties", lambda: withVertexTies(lutCase(seed + 20, 1, H, W, -0.2, 1.2, D=64))),
    ]
    errs, outside = holdLut(ailutTransform, ailutTransformPlain, cases)
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


def timingRetouch(seed, gpu):
    """Per-step and chain ms per 1080p image on a device-resident image,
    a profiler breakdown of one chain, and the device kernels one chain
    launches."""
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
    kernels = lutProfile(steps["chain"], 1)[2]
    emit(phase="retouch_timing", gpu=gpu, ms_per_image=ms, iters=ITERS, warmup=WARMUP, profiled=profiled,
         chain_top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:16]],
         chain_ailut_kernel_ms=sum(t for k, t in rows if isLutKernel(k)),
         chain_device_launches=sum(kernels.values()))


def profiledCalls(fn, iters):
    """``iters`` calls of ``fn`` under the profiler, after one call outside
    it.  The profiler can drop the records of some launches (on an H100,
    2 of every 10 in some windows late in this script), so a time is taken
    per recorded launch, never as a window's sum over ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def lutProfile(fn, iters=ITERS, windows=3):
    """Over ``iters`` calls of ``fn`` under the profiler: the device ms of
    the AiLUT launches summed and divided by ``iters`` (as this script
    timed the kernel before: low by the share of records dropped), the
    device ms of a call (each kernel's mean a launch times its launches a
    call), the launches a call by kernel name, and the AiLUT launches
    recorded (``iters`` when none was dropped).  A window that recorded
    under half the calls' AiLUT launches is profiled again, up to
    ``windows`` times (the profiler has dropped a whole window of them on
    an H100)."""
    for _ in range(windows):
        prof = profiledCalls(fn, iters)
        rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if 2 * sum(n for k, _, n in rows if isLutKernel(k)) >= iters:
            break
    perCall = {k[:80]: max(1, round(n / iters)) for k, _, n in rows}
    return (sum(t for k, t, _ in rows if isLutKernel(k)) / iters,
            sum(t / n * perCall[k[:80]] for k, t, n in rows), perCall,
            sum(n for k, _, n in rows if isLutKernel(k)))


def launchMs(fn, iters):
    """(start, name, device ms) of every device kernel and copy that
    ``iters`` calls of ``fn`` launch under the profiler, in launch order."""
    prof = profiledCalls(fn, iters)
    return sorted((e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def spread(ms):
    s = sorted(ms)
    return {"n": len(s), "min": s[0], "median": s[len(s) // 2], "max": s[-1]} if s else {"n": 0}


def medianLaunchMs(fn, match, iters=ITERS, windows=3):
    """Median device ms of the launches of the kernels ``match`` accepts
    over ``iters`` calls of ``fn``, and how many the profiler recorded.  A
    window that recorded under half the calls' launches is profiled again,
    up to ``windows`` times (the profiler has dropped a whole window of
    warp launches on an H100)."""
    for _ in range(windows):
        ms = [t for _, k, t in launchMs(fn, iters) if match(k)]
        if 2 * len(ms) >= iters:
            break
    if not ms:
        raise AssertionError(f"the profiler recorded no launch of the kernel in {windows} windows")
    return spread(ms)["median"], len(ms)


def timeLut(kernel, plain, img, table, vertices, iters=2 * ITERS):
    """One AiLUT kernel on one input, each launch timed apart under the
    profiler, ``iters`` calls in each of three states of L2: ``warm``, back
    to back (at 1080p the 25 MB image and the 25 MB output are about the
    card's 50 MB of L2, so whether one call leaves the image there for the
    next depends on where the two lie); ``cold``, each call after
    L2_FLUSH_BYTES written to scratch (the image from HBM); ``hot``, each
    call after a reduction that reads the whole image (the image in L2, as
    the step before leaves it on the retouch chain).  Then, the same way,
    ``copy``, a copy of the image (the bytes of the kernel's bound at the
    memory rate the card gives now) and ``mm``, a bf16 4096^3 product (the
    clock it gives now).  ``ms`` is the warm median.  Beside them the
    lookup's device ms as this script took it before (lutProfile), the
    device ms of a call (the wrapper's LUT re-layout included) and its
    kernels, the wrapper's ms by CUDA events, the plain version and the
    bound."""
    fn = lambda: kernel(img, table, vertices)  # noqa: E731
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def cold():
        scratch.zero_()
        fn()

    def hot():
        img.amax()
        fn()

    times, windows = {}, {}
    for name, f in (("warm", fn), ("cold", cold), ("hot", hot)):
        # a dropped record shortens the list, not a time; a window that recorded under half its launches
        # (2 of 20 in one run) is profiled again, at most three times in all
        for windows[name] in range(1, 4):
            ms = [t for _, k, t in launchMs(f, iters) if isLutKernel(k)]
            if iters // 2 <= len(ms) <= iters:
                break
        if not iters // 2 <= len(ms) <= iters:
            raise AssertionError(f"{kernel.__name__}: {len(ms)} lookups recorded in {iters} calls")
        times[name] = spread(ms)
    dst = torch.empty_like(img)
    a = torch.rand((4096, 4096), device="cuda").to(torch.bfloat16)
    times["copy"] = spread([t for _, _, t in launchMs(lambda: dst.copy_(img), iters)])
    times["mm"] = spread([t for _, _, t in launchMs(lambda: a @ a, iters)])
    del scratch, dst, a
    sumMs, callMs, kernels, recorded = lutProfile(fn)
    if sum(n for k, n in kernels.items() if isLutKernel(k)) != 1:
        raise AssertionError(f"{kernel.__name__} launched {kernels} a call")
    bound, boundBy = lutBound(img, table, vertices)
    ms = times["warm"]["median"]
    return dict(ms=ms, cold_ms=times["cold"]["median"], hot_ms=times["hot"]["median"], launch_ms=times,
                profiled_windows=windows,
                summed_ms=sumMs, summed_recorded=recorded, call_device_ms=callMs, kernels_per_call=kernels,
                wrapper_ms=cudaTimeMs(fn, ITERS),
                plain_ms=cudaTimeMs(lambda: plain(img, table, vertices), 3), bound_ms=bound, bound_by=boundBy,
                share_of_bound=bound / ms)


def smoothImage(seed, h=H, w=W):
    """A seeded 16x9 grid of colours bilinearly enlarged to h x w."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grid = torch.rand((1, 3, 9, 16), generator=g, device="cuda")
    big = torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)
    return big.permute(0, 2, 3, 1).contiguous()


def timingLut(seed, gpu, lutInput, lutModel):
    """K4 and K5 at 1080p fp32 with the chain's LUT and vertices (timeLut)
    on four inputs: the chain's AiLUT input, a smooth image, a constant one
    (every pixel in one cell) and uniform random colours inside the vertex
    range (no colour locality)."""
    from moephoto_tpu_torch.ops.lut import (ailutTransform, ailutTransformClamped, ailutTransformClampedPlain,
                                            ailutTransformPlain)

    with torch.inference_mode():
        _, table, vertices = lutModel.generate(lutInput)
    v0, v1 = vertices[:, :, 0].max(), vertices[:, :, -1].min()
    g = torch.Generator(device="cuda").manual_seed(seed + 98)
    inputs = {"chain": lutInput.contiguous(), "smooth": smoothImage(seed + 96),
              "constant": torch.tensor([0.31, 0.52, 0.68], device="cuda").expand(1, H, W, 3).contiguous(),
              "random_in_range": v0 + (v1 - v0) * torch.rand((1, H, W, 3), generator=g, device="cuda")}
    report = {}
    for kname, kernel, plain in (("ailutTransform", ailutTransform, ailutTransformPlain),
                                 ("ailutTransformClamped", ailutTransformClamped, ailutTransformClampedPlain)):
        for iname, img in inputs.items():
            report[f"{kname}_{iname}"] = timeLut(kernel, plain, img, table, vertices)
    emit(phase="kernel_timing", gpu=gpu, kernel="ailutTransform+ailutTransformClamped", shape=[1, H, W, 3],
         D=table.shape[-1], l2_flush_bytes=L2_FLUSH_BYTES, by_input=report,
         library="none: F.grid_sample samples uniform grids only")
    k4 = report["ailutTransform_chain"]
    return dict(ms=k4["ms"], cold_ms=k4["cold_ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
                bound_by=k4["bound_by"])


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
    with PathWarps() as warps, FrameCapture() as cap:
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
    return launches["warp"], warps.inputs, [np.frombuffer(b, np.uint16) for b in cap.frames]


def slomoStream(opt, collect):
    from moephoto_tpu_torch.models.ifrnet import doSlomo
    from moephoto_tpu_torch.progress import Node

    return doSlomo(lambda x: None if x is None else [collect(x)], Node({"op": "smoke"}), opt)


def checkOutputPath(seed, gpu):
    """The output path on the card against the host path it replaced
    (``imageio.toOutput`` over the float32 copy, then for video the flip
    and ``imageio.toBuffer``), bit for bit: the image route's array of two
    1080p lite x4 outputs at 8 bits (the first unchanged after the second,
    in page-locked memory) and the video route's bytes of slomo frames at
    16 bits.  Each path timed once warm, by the host's clock."""
    from functools import reduce

    from moephoto_tpu_torch.models.ifrnet import getOpt
    from moephoto_tpu_torch.pipeline import registry, steps
    from moephoto_tpu_torch.utils import imageio

    def timed(fn, x):
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x)
        return out, (time.perf_counter() - t0) * 1e3

    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    ex = registry.getSR({"model": "lite", "scale": UPSCALE})  # built by the main path
    images = [ex(torch.rand((H, W, 3), generator=g, device="cuda")) for _ in range(2)]
    fs, _, _ = steps.procOutput({}, dict(load=1, bitDepth=8, channel=0, source=0, sf=1))
    device = lambda y: reduce(lambda v, f: f(v), fs, y)
    host = lambda y: imageio.toOutput(y.float().cpu().numpy(), 8)
    first, deviceMs = timed(device, images[0])
    kept = first.copy()
    want, hostMs = timed(host, images[0])
    second = device(images[1])
    same = [np.array_equal(first, want), np.array_equal(second, host(images[1])), np.array_equal(first, kept)]
    pinned = torch.from_numpy(first).is_pinned()
    if not (all(same) and first.dtype == want.dtype and first.shape == (H * UPSCALE, W * UPSCALE, 3) and pinned
            and not np.shares_memory(first, second)):
        raise AssertionError(f"output path, image: equal {same}, dtype {first.dtype}, shape {first.shape}, "
                             f"pinned {pinned}")
    image = dict(shape=list(first.shape), dtype=str(first.dtype), out_bytes=first.nbytes, device_path_ms=deviceMs,
                 host_path_ms=hostMs, pinned=pinned)
    del images, first, second, kept, want

    frames = []
    f = slomoStream(getOpt(dict(SLOMO[0])), frames.append)
    for _ in range(2):
        f(torch.rand((H, W, 3), generator=g, device="cuda"))
    f(None)
    fs, _, _ = steps.procOutput({}, dict(load=1, bitDepth=16, channel=0, source=1, sf=1))
    device = lambda y: fs[0](y)[0]
    host = lambda y: imageio.toBuffer(imageio.toOutput(y.float().cpu().numpy(), 16)[..., ::-1], 16)
    got, deviceMs = timed(device, frames[1])
    want, hostMs = timed(host, frames[1])
    differ = [i for i, fr in enumerate(frames) if device(fr) != host(fr)]
    if got != want or differ or len(got) != H * W * 6:
        raise AssertionError(f"output path, video: {len(got)} bytes, frames {differ} of {len(frames)} differ")
    emit(phase="output_path", gpu=gpu, image=image, frame=dict(frames=len(frames), dtype=str(frames[1].dtype),
         out_bytes=len(got), device_path_ms=deviceMs, host_path_ms=hostMs))


# K7's plans, (h, w, TileSpec fields or None for lite x4's): lite x4 at 1080p (40
# tiles, 4 chunks of 10) and two of sr_lite4_small_mixed's (1 x 1 tiles,
# one padded chunk; 3 x 4 tiles, a chunk of 10 and a padded one of 2) as
# channel-split bf16 planes; and 25 x 25 fp32 NHWC tiles in chunks of 300
# (a chunk over blend.MAX_TILES takes two launches)
BLEND_PLANS = ((H, W, None), (240, 320, None), (720, 960, None), (600, 600, (32, 4, 8, 1.0, 300)))


def blendPlan(h, w, spec, g, split):
    """``tiledApply``'s blend for an (h, w) image under ``spec``: the
    canvas's shape, padSc, and per chunk its padded tile outputs, the
    tiles' canvas origins and edge flags.  ``split``: lite's channel-split
    bf16 planes (channel stride oth * otw); else contiguous fp32 NHWC."""
    from moephoto_tpu_torch.engine.tiling import paddedExtent, planAxis

    tile, pad, align, sc = spec.tile, spec.pad, spec.align, spec.scale
    ph, pw = paddedExtent(h, tile, pad, align), paddedExtent(w, tile, pad, align)
    ys, xs = planAxis(h, tile, pad), planAxis(w, tile, pad)
    oth, otw = int(round(min(tile, ph) * sc)), int(round(min(tile, pw) * sc))
    places = [((int(round(y * sc)), int(round(x * sc))), (iy == 0, iy == len(ys) - 1, ix == 0, ix == len(xs) - 1))
              for iy, y in enumerate(ys) for ix, x in enumerate(xs)]
    chunks = []
    for start in range(0, len(places), spec.batch):
        part = places[start : start + spec.batch]
        if split:
            tiles = torch.rand((spec.batch, 3, oth, otw), generator=g, device="cuda", dtype=torch.bfloat16)
            tiles = tiles.permute(0, 2, 3, 1)
        else:
            tiles = torch.rand((spec.batch, oth, otw, 3), generator=g, device="cuda")
        chunks.append((tiles, [o for o, _ in part], [e for _, e in part]))
    return (int(round(ph * sc)), int(round(pw * sc)), 3), int(round(pad * sc)), chunks


def blendBytes(shape, chunks):
    """K7's least bytes for a plan: each chunk's covered canvas pixels and
    their weights read and written once in fp32, each blended tile read
    once."""
    total = 0
    for tiles, origins, _ in chunks:
        th, tw, c = tiles.shape[1:]
        mask = torch.zeros(shape[:2], dtype=torch.bool, device="cuda")
        for oy, ox in origins:
            mask[oy : oy + th, ox : ox + tw] = True
        total += int(mask.sum()) * (c + 1) * 4 * 2 + len(origins) * th * tw * c * tiles.element_size()
    return total


def checkBlend(seed, gpu):
    """K7 (``ops/blend.py`` ``blendTiles``) against its plain loop
    (``blendTilesPlain``) on the card, canvas and weight bit for bit, on
    lite x4's 1080p plan and two of the small cell's, one launch a chunk;
    K7's time on each plan beside its byte bound and the plain loop's
    (the engine's blend before K7: each new window copied to the card); a
    1080p lite x4 image through ``ModelExec`` with K7 and with the plain
    loop, in turns (host clock to a synchronise, median of 9 each); the
    ``blend_uploads`` counter on three profiled images after the ramp cache
    is emptied (1, then 0, 0); and a warm image under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the engine
    waits for the card, where the plain loop's window copies raise.  Returns
    K7's row for the kernels line, with the largest |K7 - plain| over the
    plans."""
    from torch.profiler import ProfilerActivity, profile

    from moephoto_tpu_torch.engine import tiling
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.ops import blend
    from moephoto_tpu_torch.pipeline.registry import SR_REGISTRY
    from moephoto_tpu_torch.synth import synthLite2Params

    spec = SR_REGISTRY[f"lite{UPSCALE}"]["spec"]
    g = torch.Generator(device="cuda").manual_seed(seed + 42)
    plans, k7, maxErr = {}, None, 0.0
    for h, w, planSpec in BLEND_PLANS:
        shape, padSc, chunks = blendPlan(h, w, tiling.TileSpec(*planSpec) if planSpec else spec, g, planSpec is None)
        fresh = lambda: (torch.zeros(shape, device="cuda"), torch.zeros(shape[:2] + (1,), device="cuda"))
        got, want = fresh(), fresh()
        before = blend.blendTiles.launches
        for tiles, origins, edges in chunks:
            blend.blendTiles(*got, tiles, origins, edges, padSc)
            blend.blendTilesPlain(*want, tiles, origins, edges, padSc)
        torch.cuda.synchronize()
        launches = blend.blendTiles.launches - before
        same = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(got, want)]
        maxErr = max([maxErr] + [float((a - b).abs().max()) for a, b in zip(got, want)])
        if not all(same) or launches != sum(-(-len(o) // blend.MAX_TILES) for _, o, _ in chunks):
            raise AssertionError(f"blendTiles at {h}x{w}: canvas and weight equal {same}, {launches} launches "
                                 f"for {len(chunks)} chunks of up to {len(chunks[0][1])} tiles")
        ms = cudaTimeMs(lambda: [blend.blendTiles(*got, *c, padSc) for c in chunks], ITERS)
        plainMs = cudaTimeMs(lambda: [blend.blendTilesPlain(*want, *c, padSc) for c in chunks], 3)
        nbytes = blendBytes(shape, chunks)
        bound = nbytes / PEAK_BYTES * 1e3
        if not bound <= ms:
            raise AssertionError(f"blendTiles took {ms} ms at {h}x{w}, under its bound of {bound} ms")
        plans[f"{h}x{w}_{str(chunks[0][0].dtype)[6:]}"] = dict(
            tiles=sum(len(o) for _, o, _ in chunks), chunks=len(chunks), canvas=list(shape),
            tile=list(chunks[0][0].shape[1:]), launches=launches, equal=same, ms=ms, plain_ms=plainMs,
            bound_ms=bound, bound_by="bytes", bytes=nbytes, share_of_bound=bound / ms)
        k7 = k7 or dict(ms=ms, plain_ms=plainMs, bound_ms=bound, bound_by="bytes", launches=launches)
        del got, want, chunks

    model = MoeNetLite2(UPSCALE)
    model.load_state_dict(synthLite2Params(UPSCALE, seed), strict=True)
    model = model.to("cuda", torch.bfloat16).eval().to(memory_format=torch.channels_last)
    ex = ModelExec(model, spec, channelSplit=True, dtype=torch.bfloat16, device="cuda")
    x = torch.rand((H, W, 3), generator=g, device="cuda")
    ex(x)
    torch.cuda.synchronize()

    def imageMs():
        t0 = time.perf_counter()
        ex(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    kernelTimes, loopTimes = [], []
    for i in range(18):  # K7 and the plain loop in turns
        tiling.blendTiles = blend.blendTiles if i % 2 == 0 else blend.blendTilesPlain
        (kernelTimes if i % 2 == 0 else loopTimes).append(imageMs())
    tiling.blendTiles = blend.blendTiles

    blend._tables.clear()
    uploads = []
    for _ in range(3):  # one profile an image: the ramp copies each made
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ex(x)
            torch.cuda.synchronize()
        uploads.append(sum(int(e.name.split("=")[1]) for e in prof.events()
                           if e.name.startswith("moe.count.blend_uploads=")))
    if uploads != [1, 0, 0]:
        raise AssertionError(f"blend_uploads read {uploads} on three images after the ramp cache was emptied")

    def underSyncDebug(blendFn):  # an image with ``blendFn`` as the engine's blend; the error it raised
        tiling.blendTiles = blendFn
        torch.cuda.set_sync_debug_mode("error")
        try:
            return ex(x), None
        except RuntimeError as e:
            return None, str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
            tiling.blendTiles = blend.blendTiles
            torch.cuda.synchronize()

    want = ex(x)
    got, err = underSyncDebug(blend.blendTiles)
    _, loopErr = underSyncDebug(blend.blendTilesPlain)  # the control: the plain loop's window copies wait
    if err is not None or not torch.equal(got, want) or loopErr is None:
        raise AssertionError(f"under sync debug mode K7's image raised {err!r} (equal to the one before: "
                             f"{got is not None and torch.equal(got, want)}), the plain loop's {loopErr!r}")
    emit(phase="blend", gpu=gpu, plans=plans, image_ms=spread(kernelTimes), image_ms_loop=spread(loopTimes),
         blend_uploads=uploads, sync_debug={"k7": "nothing raised", "plain_loop": loopErr})
    return dict(k7, max_abs_err=maxErr)


# K8 against its plain versions: fp32 within 1e-5 * max(1, |plain|); bf16 within one bf16 ulp of
# max(|plain|, 2^-8) (tests/test_torch_layernorm.py: the two sum in another order, and an output that
# cancels below 2^-8 carries a few fp32 ulps of its terms); mode (b)'s z bit-equal
LN_EPS, LN_ULP_FLOOR = 1e-5, 2.0**-8
LN_WIDTHS = (32, 64, 128, 256, 512, 1024)
# NAFNet-SIDD-32's norms in the cell: a chunk of four 256x256 tiles at each level, (name, C, side, norms a
# chunk): 2 a block, encoder + decoder blocks (2 + 2, 2 + 2, 4 + 2, 8 + 2) and the 12 middle blocks
LN_LEVELS = (("level0", 32, 256, 8), ("level1", 64, 128, 8), ("level2", 128, 64, 12), ("level3", 256, 32, 20),
             ("middle", 512, 16, 24))
NAF_CHUNKS = 12  # a 1080p image in NAFNet_32's tiles: 48 tiles in chunks of 4


def isK8(name: str) -> bool:
    return "nhwcLayerNorm" in name


def isAtenNorm(name: str) -> bool:  # PyTorch's layer-norm forward kernels (benchmark/metrics/norm_ms.dn.py less K8)
    return ("layer_norm" in name or "LayerNorm" in name or "RowwiseMoments" in name) and not isK8(name)


def lnCase(seed, shape, dtype):
    """NCHW views of channels-last x (around 3) and y, and the four per-channel parameters."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, c, h, w = shape
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = (3 + rnd(n, h, w, c)).to(dtype).permute(0, 3, 1, 2)
    y = rnd(n, h, w, c).to(dtype).permute(0, 3, 1, 2)
    return x, y, (0.2 * rnd(c)).to(dtype), (0.5 * rnd(1, c, 1, 1)).to(dtype), (1 + 0.3 * rnd(c)).to(dtype), \
        (0.3 * rnd(c)).to(dtype)


def lnErr(got, want):
    """(largest |got - want| over its tolerance, largest |got - want|)."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        tol = 1e-5 * want.float().abs().clamp_min(1.0)
    else:
        tol = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(LN_ULP_FLOOR))) - 7)
    return float((err / tol).max()), float(err.max())


def flushedMs(fn, iters=ITERS):
    """Median device ms of one call of ``fn``, each of ``iters`` calls timed
    by a pair of CUDA events after L2_FLUSH_BYTES written to scratch (its
    inputs come from HBM) and a ~1 ms device sleep, which gives the host the
    lead to enqueue the whole call before the device reaches it: the events
    time the device's work, not the wrapper's host path."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(2_000_000)  # clock cycles: ~1 ms at the H100's 1.98 GHz
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return spread(times)["median"]


def checkLayerNorm(seed, gpu):
    """K8 (``ops/layernorm.py``) on the card: both modes against the plain
    versions at C = 32-1024 on ragged row counts, fp32 and bf16, ``z``
    bit-equal; then at the NAFNet cell's five level shapes in bf16, each
    call after an L2 flush (flushedMs): K8 in both modes beside its byte
    bound (mode (a) reads and writes the tensor once, (b) reads two and
    writes two), the plain versions, and F.layer_norm (the library
    yardstick for mode (a), which moves its bytes; the port never calls
    it).  Returns K8's row for the kernels line: mode (a) at level 0 beside
    its plain version, bound and F.layer_norm, mode (b) in fields of its
    own."""
    import torch.nn.functional as F

    from moephoto_tpu_torch.ops import layernorm as LN

    checks, maxErr = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, c in enumerate(LN_WIDTHS):
            worst = 0.0
            for shape in ((2, c, 7, 13), (1, c, 129, 67), (3, c, 33, 5)):
                x, y, yb, beta, w, b = lnCase(seed + i, shape, dtype)
                before = LN.layerNorm.launches
                n = LN.layerNorm(x, w, b, LN_EPS)
                z, n2 = LN.residualLayerNorm(x, y, yb, beta, w, b, LN_EPS)
                torch.cuda.synchronize()
                launches = LN.layerNorm.launches - before
                zp, n2p = LN.residualLayerNormPlain(x, y, yb, beta, w, b, LN_EPS)
                errs = [lnErr(n, LN.layerNormPlain(x, w, b, LN_EPS)), lnErr(n2, n2p)]
                if not (torch.equal(z, zp) and all(r <= 1.0 for r, _ in errs) and launches == 2):
                    raise AssertionError(f"K8 at {shape} {dtype}: z equal {torch.equal(z, zp)}, (error / tolerance, "
                                         f"error) {errs}, {launches} launches")
                worst = max([worst] + [r for r, _ in errs])
                maxErr = max([maxErr] + [e for _, e in errs])
            checks[f"{c}_{str(dtype)[6:]}"] = worst

    levels = {}
    for name, c, side, count in LN_LEVELS:
        x, y, yb, beta, w, b = lnCase(seed, (4, c, side, side), torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        boundA, boundB = 2 * nbytes / PEAK_BYTES * 1e3, 4 * nbytes / PEAK_BYTES * 1e3
        msA = flushedMs(lambda: LN.layerNorm(x, w, b, LN_EPS))
        msB = flushedMs(lambda: LN.residualLayerNorm(x, y, yb, beta, w, b, LN_EPS))
        levels[name] = dict(
            shape=[4, side, side, c], norms_a_chunk=count, tensor_bytes=nbytes,
            a=dict(ms=msA, bound_ms=boundA, share_of_bound=boundA / msA,
                   plain_ms=flushedMs(lambda: LN.layerNormPlain(x, w, b, LN_EPS)),
                   library_ms=flushedMs(lambda: F.layer_norm(x.permute(0, 2, 3, 1), (c,), w, b, LN_EPS))),
            b=dict(ms=msB, bound_ms=boundB, share_of_bound=boundB / msB,
                   plain_ms=flushedMs(lambda: LN.residualLayerNormPlain(x, y, yb, beta, w, b, LN_EPS))))
    # half of a level's norms are each block's first (mode (a)), half its second (mode (b))
    estimate = NAF_CHUNKS * sum(v["norms_a_chunk"] / 2 * (v["a"]["ms"] + v["b"]["ms"]) for v in levels.values())
    libEstimate = NAF_CHUNKS * sum(v["norms_a_chunk"] * v["a"]["library_ms"] for v in levels.values())
    emit(phase="layernorm", gpu=gpu, tolerance=f"fp32 1e-5*max(1,|plain|); bf16 one ulp of max(|plain|, {LN_ULP_FLOOR})",
         error_over_tolerance=checks, max_abs_err=maxErr, timing="each call after an L2 flush, CUDA events",
         levels=levels, image_norm_ms_estimate=estimate, image_library_norm_ms_estimate=libEstimate)
    a, b = levels["level0"]["a"], levels["level0"]["b"]
    return dict(ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], library_ms=a["library_ms"],
                ms_b=b["ms"], plain_ms_b=b["plain_ms"], bound_ms_b=b["bound_ms"], max_abs_err=maxErr)


def checkInputPath(seed, gpu):
    """The input path on the card (``pipeline/steps.toDevice``: the
    integers uploaded, widened there) against the host conversion it
    replaced (``astype(np.float32) / 255.0`` or ``/ 65536.0``, then the
    float32 upload), bit for bit: the 256 byte values, the 65536 16-bit
    values and a seeded 1080p RGB image.  Each path timed warm by the
    host's clock, the median of 9 calls, each ending in a synchronise."""
    from moephoto_tpu_torch.pipeline import steps

    def host(arr):
        scale = 255.0 if arr.dtype == np.uint8 else 65536.0
        return torch.from_numpy(arr.astype(np.float32) / scale).to("cuda")

    def medianMs(fn, arr):
        fn(arr)
        torch.cuda.synchronize()
        times = []
        for _ in range(9):
            t0 = time.perf_counter()
            fn(arr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    cases = {"bytes": np.repeat(np.arange(256, dtype=np.uint8), 3).reshape(16, 16, 3),
             "uint16": np.arange(65536, dtype=np.uint16).reshape(256, 256, 1),
             "image_1080p": np.random.RandomState(seed + 41).randint(0, 256, (H, W, 3)).astype(np.uint8)}
    out = {}
    for name, arr in cases.items():
        got, want = steps.toDevice(arr), host(arr)
        same = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        if not (same and got.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous()
                and got.device.type == "cuda"):
            raise AssertionError(f"input path, {name}: equal {same}, dtype {got.dtype}, shape {tuple(got.shape)}")
        out[name] = dict(shape=list(arr.shape), in_bytes=arr.nbytes)
    image = cases["image_1080p"]
    out["image_1080p"].update(device_path_ms=medianMs(steps.toDevice, image), host_path_ms=medianMs(host, image))
    emit(phase="input_path", gpu=gpu, cases=out)


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

    kernelMs = lambda img, flow: medianLaunchMs(lambda: warp(img, flow), isWarpKernel)[0]  # noqa: E731
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
    return "::dcnKernel<" in name or "::dcnMmaKernel<" in name


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
        # the tensor-core instance's tiles are 16 x 16 pixels of one image
        "under_one_tile_1x5x7x64_bfloat16": (1, 5, 7, 64, 64, 8, bf, bf, 3.0),
        "ragged_tiles_3x130x131x64_bfloat16": (3, 130, 131, 64, 64, 8, bf, bf, 5.0),
        "cout128_1x33x47x64_bfloat16": (1, 33, 47, 64, 128, 8, bf, bf, 10.0),
        "c128_1x33x47_cout64_bfloat16": (1, 33, 47, 128, 64, 8, bf, bf, 10.0),
        "c128_1x33x47_cout128_bfloat16": (1, 33, 47, 128, 128, 8, bf, bf, 10.0),
        "dg6_1x21x23x48_cout96_bfloat16_fp32_offsets": (1, 21, 23, 48, 96, 6, bf, f32, 6.0),
    })
    errs, launched = {}, {}
    for i, (name, (B, h, w, c, cout, dg, dtype, offDtype, scale)) in enumerate(cases.items()):
        x, off, mask, weight, bias, dg = dcnCase(seed + 70 + i, B, h, w, c, cout, dg, dtype, offDtype, scale)
        if name.startswith("huge"):  # 1e6 everywhere but a few NaN offsets
            off[0, ::9, ::7, 5] = float("nan")
        got = deformConv2d(x, off, mask, weight, bias, dg).float()
        launched[name] = deformConv2d.lastInstance
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
    # the weights of C = 128 do not fit beside the sample buffers; 12 channels are no multiple of 16
    want = {"path_l1_7x384x640x64_bfloat16": "mma", "path_l1_7x384x640x64_float32": "cuda_core",
            "huge_nan_1x64x96x64_bfloat16": "mma", "ragged_1x37x101x64_cout96_bfloat16_fp32_offsets": "mma",
            "cout128_1x33x47x64_bfloat16": "mma", "c128_1x33x47_cout64_bfloat16": "cuda_core",
            "c128_1x33x47_cout128_bfloat16": "cuda_core", "scalar_loads_1x29x53x12_cout20_dg4_bfloat16": "cuda_core",
            "dg6_1x21x23x48_cout96_bfloat16_fp32_offsets": "mma"}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"deformConv2d launched {launched}, want {want}")
    emit(phase="kernels", kernel="deformConv2d", fp32_tol=f"{DCN_FP32_TOL}*max(1,|plain|)",
         bf16_tol=f"{DCN_BF16_REL}*|plain|+{DCN_BF16_ABS}", max_abs_err=errs, instance=launched)
    return errs["path_l1_7x384x640x64_bfloat16"]


class DcnRecorder:
    """Stands in for ``ops.deform.deformConv2d``: calls ``record`` on each
    call's arguments, then the wrapper; ``launches`` is the wrapper's own
    count, which the wrapper keeps through its module's name."""

    def __init__(self, orig, record):
        self.orig, self.record = orig, record

    def __call__(self, *args, **kw):
        self.record(*args)
        return self.orig(*args, **kw)

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


class PathVsrWarps:
    """While installed (it wraps ``iconvsr.backWarp``, which SpyNet's levels
    and the recurrences' ``propWarp`` call, and ``iconvsr.toFloat``, which
    takes each scan's flows): the first (image, flow, mode) of each warp
    shape and mode, and for a zeros-mode warp (``propWarp``) the row reach
    of its scan's flows, which the row-sharded scan reads once and passes
    to ``backWarpSpmd``."""

    def __enter__(self):
        from moephoto_tpu_torch.models import iconvsr
        from moephoto_tpu_torch.ops.warp import rowReach

        self.module, self.orig, self.inputs, scan = iconvsr, (iconvsr.backWarp, iconvsr.toFloat), {}, [None]

        def flows(x):
            out = self.orig[1](x)
            scan[0] = rowReach([out], 1)
            return out

        def record(img, flow, mode):
            key = f"{shapeKey(img)}_{mode}"
            if key not in self.inputs:
                self.inputs[key] = (img.clone(), flow.clone(), mode, scan[0] if mode == "zeros" else None)
            return self.orig[0](img, flow, mode)

        iconvsr.backWarp, iconvsr.toFloat = record, flows
        return self

    def __exit__(self, *exc):
        self.module.backWarp, self.module.toFloat = self.orig
        return False


def runVsr(work):
    """The CLI's video path with IconVSR x4, as a user calls it, on the
    card in bf16: 22 decoded 640x360 frames -> 22 encoded at 2560x1440.
    Returns the DCN launches, the DCN and warp inputs the path gave (to
    hold and time the kernels on), the frames and EDVR's calls."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = f"{VSR_W}x{VSR_H}", str(VSR_FRAMES)
    dst = os.path.join(work, "vsr.mkv")
    with PathDcn() as dcn, PathVsrWarps() as warps, FrameCapture() as cap:
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
    return (launches["deformConv2d"], dcn.inputs, [np.frombuffer(b, np.uint16) for b in cap.frames], edvrCalls,
            warps.inputs)


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
        kernelMs, _ = medianLaunchMs(lambda: deformConv2d(x, off, mask, weight, bias, dg), isDcnKernel)
        variant = deformConv2d.lastInstance
        wrapperMs = cudaTimeMs(lambda: deformConv2d(x, off, mask, weight, bias, dg), ITERS)
        oldMs = cudaTimeMs(lambda: deformConv2d(x, off, mask, weight, bias, dg, instance="cuda_core"), 3)
        plainMs = cudaTimeMs(lambda: deformConv2dPlain(x, off, mask, weight, bias, dg), 2)
        bound, boundBy = dcnBound(x, off, mask, weight.shape[0])
        if not bound <= kernelMs:
            raise AssertionError(f"deformConv2d at {lv} took {kernelMs} ms, under its bound of {bound} ms")
        shapes[lv] = dict(shape=list(x.shape), dtype=str(x.dtype)[6:], offset_dtype=str(off.dtype)[6:],
                          offset_strides=list(off.stride()), ms=kernelMs, wrapper_ms=wrapperMs, variant=variant,
                          cuda_core_wrapper_ms=oldMs, plain_ms=plainMs, bound_ms=bound, bound_by=boundBy,
                          share_of_bound=bound / kernelMs, library_ms=None)
    emit(phase="kernel_timing", gpu=gpu, kernel="deformConv2d", by_level=shapes,
         library="none: no single PyTorch call computes DCNv2 (torchvision is absent)")
    return dict(shapes["l1"])


# --- ESTRNN deblur (demob) and BASELINE config 5 --------------------------------


def smokeESTRNNParams(seed):
    """synthESTRNNParams(seed) with the reconstructor's last conv scaled by
    DEMOB_OUT_GAIN and its bias raised by 0.5."""
    from moephoto_tpu_torch.synth import synthESTRNNParams

    sd = synthESTRNNParams(seed)
    sd["recons"]["2.weight"] *= DEMOB_OUT_GAIN
    sd["recons"]["2.bias"] += 0.5
    return sd


def runDemob(work):
    """The CLI's video path with ``demob`` (ESTRNN 1ms8ms in bf16), as a user
    calls it: 9 decoded 1280x720 frames -> 9 encoded; then BASELINE config 5,
    demob -> IFRNet-M slomo x2: 9 -> 17 encoded, 8 K2 launches an
    interpolated frame.  Returns the demob run's raw output frames."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = f"{DEMOB_W}x{DEMOB_H}", str(DEMOB_FRAMES)
    out = {}
    for name, steps, count in (("demob", DEMOB, DEMOB_FRAMES), ("config5", CONFIG5, 2 * DEMOB_FRAMES - 1)):
        with FrameCapture() as cap:
            resetCounts()
            t0 = time.perf_counter()
            path, frames = cli.runVideo(os.path.join(work, "in.mkv"), os.path.join(work, f"{name}.mkv"), steps)
            seconds = time.perf_counter() - t0
            launches = readCounts()
        with open(path) as fp:
            meta = json.load(fp)
        want = count * DEMOB_W * DEMOB_H * 6
        if frames != DEMOB_FRAMES or meta != {"bytes": want, "s": f"{DEMOB_W}x{DEMOB_H}"} or len(cap.frames) != count:
            raise AssertionError(f"{name}: read {frames} frames, encoder got {meta} in {len(cap.frames)} frames, "
                                 f"want {want} bytes of {DEMOB_W}x{DEMOB_H}")
        warps = 8 * (DEMOB_FRAMES - 1) if name == "config5" else 0
        if launches["warp"] != warps or sum(launches.values()) != warps:
            raise AssertionError(f"{name} launched {launches}, want {warps} warps and nothing else")
        vals = np.stack([np.frombuffer(b, np.uint16) for b in cap.frames])
        emit(phase=name, steps=steps, input=[DEMOB_FRAMES, DEMOB_H, DEMOB_W, 3], frames_read=frames,
             encoded_frames=meta["bytes"] // (DEMOB_W * DEMOB_H * 6), geometry=meta["s"], seconds=seconds,
             launches=launches, output_mean=float(vals.mean() / 65535), output_std=float(vals.std() / 65535),
             share_clipped=float(((vals == 0) | (vals == 65535)).mean()),
             slomo_model="IFRNet-M (bench.py:862 runs IFRNet S)" if name == "config5" else None)
        out[name] = [np.frombuffer(b, np.uint16) for b in cap.frames]
    return out["demob"]


def estrnnStream(opt, collect):
    from moephoto_tpu_torch.models.estrnn import doESTRNN
    from moephoto_tpu_torch.progress import Node

    return doESTRNN(lambda x: None if x is None else [collect(x)], Node({"op": "smoke"}), opt)


def feedDeblur(opt, frames, collect, pad=2):
    """A whole clip through a fresh ESTRNN stream with the reflection padding
    the video engine sets (2 frames at each end): one output a frame."""
    from moephoto_tpu_torch.models.estrnn import ESTRNNOpt

    o = ESTRNNOpt()
    o.model, o.dtype, o.start = opt.model, opt.dtype, pad
    f = estrnnStream(o, collect)
    out = []
    for fr in frames:
        out += f(fr)
    o.end = -pad
    return out + f(None)


def checkDemobCrop(seed):
    """The ESTRNN stream on 6 frames of 128x128 in fp32, on the card against
    the CPU, same weights: within DEMOB_TOL relative to max(1, |cpu|)."""
    from moephoto_tpu_torch.models.estrnn import getOpt

    frames = np.random.RandomState(seed + 7).rand(6, 128, 128, 3).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        opt = getOpt(dict(DEMOB[0]), torch.device(dev), torch.float32)
        outs[dev] = torch.stack(feedDeblur(opt, [torch.from_numpy(f).to(dev) for f in frames], lambda x: x.cpu()))
    err = (outs["cuda"] - outs["cpu"]).abs()
    tol = DEMOB_TOL * outs["cpu"].abs().clamp_min(1.0)
    if not (outs["cuda"].shape == (6, 128, 128, 3) and bool((err <= tol).all()) and torch.isfinite(outs["cuda"]).all()):
        raise AssertionError(f"demob crop: shape {tuple(outs['cuda'].shape)}, card vs CPU {float(err.max())}")
    emit(phase="demob_crop", shape=list(outs["cuda"].shape), max_abs_err=float(err.max()),
         tol=f"{DEMOB_TOL}*max(1,|cpu|)", output_range=[float(outs["cpu"].min()), float(outs["cpu"].max())])


def deblurFeeder(opt, frames):
    """A fresh ESTRNN stream with no padding on device-resident frames: feed(k)
    pushes k frames and returns the number of outputs."""
    f = estrnnStream(opt, lambda x: x.mean())
    return lambda k: sum(len(f(frames[i % len(frames)])) for i in range(k))


def layerMacs(model, fn):
    """Multiply-accumulates of every Conv2d, ConvTranspose2d and Linear of
    ``model`` that ``fn()`` runs, counted by forward hooks from the shapes
    (a ConvTranspose2d: each input value times its cout k k taps), by the
    first two parts of the layer's name."""
    nn, total = torch.nn, {}

    def hook(name):
        def count(m, inp, out):
            if isinstance(m, nn.ConvTranspose2d):
                n = inp[0].numel() * m.weight[0].numel()
            elif isinstance(m, nn.Conv2d):
                n = out.numel() * m.weight[0].numel()
            else:
                n = out.numel() * m.in_features
            total[name] = total.get(name, 0) + n
        return count

    from moephoto_tpu_torch.models.nafnet import NAFBlock

    def conv3(name):  # NAFBlock runs conv3 through F.conv2d (its bias goes to K8): c x c MACs an output value
        def count(m, inp, out):
            total[name] = total.get(name, 0) + out.numel() * m.conv3.weight[0].numel()
        return count

    handles = [m.register_forward_hook(hook(".".join(k.split(".")[:2]))) for k, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    handles += [m.register_forward_hook(conv3(".".join(k.split(".")[:2]))) for k, m in model.named_modules()
                if isinstance(m, NAFBlock)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total


def timingDemob(seed, gpu):
    """Output Mpx/s of ESTRNN at 1280x720 in bf16 on device-resident frames
    (the configuration of bench.py:556 ``_benchESTRNN``; DEMOB_TIMED frames
    after DEMOB_WARM), device ms a frame by CUDA events, its multiply-
    accumulates a frame (layerMacs), and one profiled chunk of 8 frames:
    device ms, the achieved rate, idle share, top kernels."""
    from moephoto_tpu_torch.models.estrnn import getOpt

    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = [torch.rand((DEMOB_H, DEMOB_W, 3), generator=g, device="cuda") for _ in range(8)]
    opt = getOpt(dict(DEMOB[0]))
    feed = deblurFeeder(opt, frames)
    feed(DEMOB_WARM)
    byModule = layerMacs(opt.model, lambda: feed(8))  # a chunk: 8 frames through the cell, 8 windows fused
    macs = sum(byModule.values()) / 8
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outFrames = feed(DEMOB_TIMED)
    end.record()
    torch.cuda.synchronize()
    wallS, eventS = time.perf_counter() - t0, start.elapsed_time(end) / 1e3
    wallMs, rows = profileOnce(lambda: feed(8))
    deviceMs = sum(t for _, t in rows)
    emit(phase="demob_timing", gpu=gpu, size=[DEMOB_H, DEMOB_W], warm_frames=DEMOB_WARM, timed_frames=DEMOB_TIMED,
         output_frames=outFrames, seconds_events=eventS, seconds_wall=wallS,
         output_mpx_per_s=outFrames * DEMOB_H * DEMOB_W / 1e6 / eventS, ms_per_frame_events=eventS * 1e3 / outFrames,
         profiled_frames=8, profiled_wall_ms=wallMs, profiled_device_ms=deviceMs, device_ms_per_frame=deviceMs / 8,
         gmac_per_frame=macs / 1e9, tflops_achieved=2 * macs / (deviceMs / 8 * 1e-3) / 1e12,
         mac_share_by_module={k: v / (8 * macs) for k, v in sorted(byModule.items(), key=lambda kv: -kv[1])},
         device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
         top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:16]])


def checkLutClamped(seed):
    """ailutTransformClamped (K5) against ailutTransformClampedPlain on the
    card: NaN exactly where the plain version is NaN, every other value as
    holdLut says; differing and disjoint channel ranges, ties on every
    vertex, ragged batches, less than one block of pixels, D = 17, 48 and
    64."""
    from moephoto_tpu_torch.ops.lut import ailutTransformClamped, ailutTransformClampedPlain, clampRange

    shifted = ((0.05, 0.9), (0.0, 1.0), (0.1, 0.95))  # common range [0.1, 0.9]
    unit = ((0.0, 1.0),) * 3
    disjoint = ((0.6, 1.0), (0.0, 1.0), (0.0, 0.4))
    specs = {  # B, h, w, image range, channel vertex ranges, NaN pixels, D, special
        "1080p_in_range": (1, H, W, 0.0, 1.0, unit, False, 33, None),
        "1080p_clamped_differing_ranges": (1, H, W, -0.4, 1.5, shifted, False, 33, None),
        "B2_ragged_37x1001_nan": (2, 37, 1001, -0.2, 1.2, shifted, True, 33, None),
        "disjoint_ranges_33x99": (1, 33, 99, -0.4, 1.5, disjoint, False, 33, None),
        "disjoint_ranges_512x512": (1, 512, 512, -0.4, 1.5, disjoint, False, 33, None),
        "vertex_ties_B2_600x900": (2, 600, 900, -0.2, 1.2, shifted, False, 33, withVertexTies),
        "B3_ragged_541x967_nan": (3, 541, 967, -0.4, 1.5, shifted, True, 33, None),
        "below_one_block_17x13": (1, 17, 13, -0.4, 1.5, shifted, False, 33, None),
        "D17_1080p_clamped": (1, H, W, -0.4, 1.5, shifted, False, 17, None),
        "D48_300x400_clamped": (1, 300, 400, -0.4, 1.5, shifted, False, 48, None),
        "D64_1080p_clamped": (1, H, W, -0.4, 1.5, shifted, False, 64, None),
    }
    clamped = {}

    def make(i, name, B, h, w, lo, hi, ranges, nan, D, special):
        img, lut, vertices = lutCase(seed + 90 + i, B, h, w, lo, hi, D=D)
        a = torch.tensor([r[0] for r in ranges], device="cuda")[None, :, None]
        b = torch.tensor([r[1] for r in ranges], device="cuda")[None, :, None]
        vertices = (a + (b - a) * vertices).contiguous()
        if special is not None:
            img, lut, vertices = special((img, lut, vertices))
        if nan:
            img[:, ::5, ::7, 1] = float("nan")
        vlo, vhi = (t.reshape(-1, 1, 1, 1) for t in clampRange(vertices))
        if name.startswith("disjoint") != bool((vlo > vhi).all()):
            raise AssertionError(f"{name}: lo {vlo.flatten().tolist()}, hi {vhi.flatten().tolist()}")
        clamped[name] = float(((img < vlo) | (img > vhi)).float().mean())
        return img, lut, vertices

    cases = [(name, lambda i=i, name=name, spec=spec: make(i, name, *spec))
             for i, (name, spec) in enumerate(specs.items())]
    errs, _ = holdLut(ailutTransformClamped, ailutTransformClampedPlain, cases)
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
    want = {"fusedUpHeads": 1, "ailutTransform": 1, "warp": 2, "deformConv2d": 1, "ailutTransformClamped": 1,
            "blendTiles": 0, "layerNorm": 0}
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
    others = sum(v for k, v in launches.items() if k not in ("fusedUpHeads", "blendTiles"))
    if launches["fusedUpHeads"] != wantK1 or launches["blendTiles"] < wantK1 or others:  # K7: any model's chunks
        raise AssertionError(f"{name} launched {launches}, want {wantK1} fusedUpHeads, at least as many blendTiles "
                             "and nothing else")
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
        shapes[name] = dict(shape=list(img.shape), **timeLut(ailutTransformClamped, ailutTransformClampedPlain,
                                                              img, lut, vertices))
    emit(phase="kernel_timing", gpu=gpu, kernel="ailutTransformClamped", D=33, by_shape=shapes,
         library="none: F.grid_sample samples uniform grids only")
    return shapes


# --- the rest of the image model zoo: convs, norms and attention, no hand-written kernel --

CONFIG3 = [{"op": "DN", "model": "MPRNet_denoising"}, {"op": "DN", "model": "NAFNet_32"}]
# fp32 crops on the card (TF32 off) against the CPU, times max(1, |cpu|): both devices run the same fp32
# graph and differ only in summation order (~1e-6 measured on the earlier paths); MPRNet's sigmoid gates,
# NAFNet's fp32 LayerNorm and the moire models' fp32 softmax keep their inputs' rounding, so DN_CROP_TOL holds
ZOO_TOL = DN_CROP_TOL
MOIRE_C = 64  # moire_obj's and moire_screen_gan's feature width: no source fixes it (models/demoire.py)


def zooModels():
    """Registry key -> (step, seeded full-width draw, input (w, h) of its run, side of its CPU crop).
    Config 3's two models first, then every other model the zoo phase runs once."""
    from moephoto_tpu_torch import synth

    nafGoPro = lambda w: lambda s: synth.synthNAFNetParams(w, 1, (1, 1, 1, 28), (1, 1, 1, 1), seed=s)
    dehaze = lambda m: {"op": "dehaze", "model": m}
    return {
        "MPRNet_denoising": ({"op": "DN", "model": "MPRNet_denoising"}, lambda s: synth.synthMPRNetParams(seed=s),
                             (W, H), 128),
        "NAFNet_32": ({"op": "DN", "model": "NAFNet_32"}, lambda s: synth.synthNAFNetParams(seed=s), (W, H), 128),
        "NAFNet_64": ({"op": "DN", "model": "NAFNet_64"}, lambda s: synth.synthNAFNetParams(64, seed=s),
                      (PRESET_W, PRESET_H), 128),
        "NAFNet_deblur_32": (dehaze("NAFNet_deblur_32"), nafGoPro(32), (PRESET_W, PRESET_H), 128),
        "NAFNet_deblur_64": (dehaze("NAFNet_deblur_64"), nafGoPro(64), (PRESET_W, PRESET_H), 128),
        "NAFNet_deblur_JPEG_64": (dehaze("NAFNet_deblur_JPEG_64"), nafGoPro(64), (PRESET_W, PRESET_H), 128),
        "MPRNet_deblurring": (dehaze("MPRNet_deblurring"), lambda s: synth.synthMPRNetParams(96, 48, 32, 8, seed=s),
                              (PRESET_W, PRESET_H), 128),
        "MPRNet_deraining": (dehaze("MPRNet_deraining"), lambda s: synth.synthMPRNetParams(40, 20, 16, 8, seed=s),
                             (PRESET_W, PRESET_H), 128),
        "gan2": ({"op": "SR", "model": "gan", "scale": 2}, lambda s: synth.synthRRDBParams(2, 23, seed=s), (640, 360), 64),
        "gan4": ({"op": "SR", "model": "gan", "scale": 4}, lambda s: synth.synthRRDBParams(4, 23, seed=s), (640, 360), 64),
        "gana4": ({"op": "SR", "model": "gana", "scale": 4}, lambda s: synth.synthRRDBParams(4, 6, seed=s),
                  (640, 360), 64),
        "VSR_Cleaning": ({"op": "DN", "model": "VSR_Cleaning"}, lambda s: synth.synthImageCleaningParams(seed=s),
                         (640, 360), 128),
        "moire_obj": (dehaze("moire_obj"), lambda s: synth.synthMoireObjParams(MOIRE_C, seed=s), (PRESET_W, PRESET_H),
                      128),
        "moire_screen_gan": (dehaze("moire_screen_gan"), lambda s: synth.synthMoireScreenGanParams(MOIRE_C, seed=s),
                             (W, H), 512),
    }


def zooEntry(step):
    """The registry entry of a zoo step."""
    from moephoto_tpu_torch.pipeline import registry

    if step["op"] == "SR":
        return registry.SR_REGISTRY[step["model"] + str(step["scale"])]
    return (registry.DN_REGISTRY if step["op"] == "DN" else registry.DEHAZE_REGISTRY)[step["model"]]


def zooExec(step):
    """The ModelExec a ``cli image`` step builds (once; the registry caches it)."""
    from moephoto_tpu_torch.pipeline import registry

    get = {"SR": registry.getSR, "DN": registry.getDN, "dehaze": registry.getDehaze}[step["op"]]
    return get(dict(step))


def seededImage(seed, w, h):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)


def holdZooCrop(name, step, sd, img, side):
    """The model's fp32 output on the top-left ``side`` x ``side`` crop of
    ``img``, on the card (TF32 off) and on the CPU, same weights, through
    ModelExec with the entry's tile spec; ZOO_TOL relative."""
    from moephoto_tpu_torch.engine.executor import ModelExec
    from moephoto_tpu_torch.pipeline import registry

    entry = zooEntry(step)
    x = torch.from_numpy(img[:side, :side].astype(np.float32) / 255.0)
    outs = []
    for dev in ("cuda", "cpu"):
        model = getattr(registry._lazyImport(entry["family"]), entry["fn"])()
        model.load_state_dict(sd, strict=True)
        outs.append(ModelExec(model.to(dev).eval(), entry["spec"], dtype=torch.float32, device=dev)(x).cpu())
    err = (outs[0] - outs[1]).abs()
    if not (bool((err <= ZOO_TOL * outs[1].abs().clamp_min(1.0)).all()) and torch.isfinite(outs[0]).all()):
        raise AssertionError(f"{name} crop on the card differs from the CPU by {float(err.max())}")
    return {"shape": list(outs[0].shape), "max_abs_err": float(err.max()), "cpu_std": float(outs[1].std())}


def runConfig3(seed, work, draws):
    """BASELINE config 3 through ``cli image`` on the card in bf16: DN
    MPRNet_denoising -> DN NAFNet_32 on a seeded 1920x1080 PNG; the output
    and its launches checked (K7 and NAFNet's K8 only); K8's kernels in a
    trace of one 1080p image through the CLI's own NAFNet exec (864 wanted,
    no ATen layer-norm kernel); each model's fp32 crop against the CPU.
    Returns the K8 kernels traced."""
    from PIL import Image

    from moephoto_tpu_torch import cli

    src, dst = os.path.join(work, "config3_in.png"), os.path.join(work, "config3_out.png")
    img = seededImage(seed, W, H)
    Image.fromarray(img).save(src)
    resetCounts()
    t0 = time.perf_counter()
    cli.runImage(src, dst, [dict(s) for s in CONFIG3])
    seconds = time.perf_counter() - t0
    launches = readCounts()
    with Image.open(dst) as out:
        got, mode = out.size, out.mode
        arr = np.asarray(out)
    if got != (W, H) or mode != "RGB" or not arr.std() > 0:
        raise AssertionError(f"config3: output {got} {mode} std {arr.std()}, want {(W, H)} RGB")
    # K7 blends the engine's tiles, of any model; K8 is NAFNet's LayerNorm
    if sum(v for k, v in launches.items() if k not in ("blendTiles", "layerNorm")) or not launches["layerNorm"]:
        raise AssertionError(f"config3 launched {launches}: K8 in NAFNet and no other hand-written kernel wanted")
    # the wrapper's count sees captures and eager calls, not stage-graph replays: count K8 in a trace of the
    # exec the CLI ran (the registry keeps it), on an image of the same size
    ex, x = zooExec(CONFIG3[1]), torch.from_numpy(img).cuda().float() / 255.0
    traced = []
    for _ in range(3):  # the profiler can drop records: the window with the most
        evs = [v for v in profiledCalls(lambda: ex(x), 1).events() if v.device_type == torch.autograd.DeviceType.CUDA]
        traced.append((sum(1 for e in evs if isK8(e.name)), sum(1 for e in evs if isAtenNorm(e.name)),
                       sum(e.time_range.elapsed_us() for e in evs if isK8(e.name)) / 1e3, len(evs)))
        if traced[-1][0] == 864:
            break
    k8, aten, k8Ms, kernels = max(traced)
    if k8 != 864 or aten:
        raise AssertionError(f"a 1080p image through the CLI's NAFNet_32 exec traced {k8} K8 kernels (864 wanted) "
                             f"and {aten} ATen layer-norm kernels (none wanted): {traced}")
    crops = {}
    for name in ("MPRNet_denoising", "NAFNet_32"):
        step, _, _, side = zooModels()[name]
        crops[name] = holdZooCrop(name, step, draws[name], img, side)
    emit(phase="config3", steps=CONFIG3, input=[H, W, 3], output=list(arr.shape), seconds=seconds, launches=launches,
         kernels="K8 (NAFNet's LayerNorm); cuDNN convs, MPRNet's norms, elementwise passes; K7 blends the tiles",
         nafnet_image_trace={"k8_kernels": k8, "k8_ms": k8Ms, "aten_norm_kernels": aten, "kernels": kernels,
                             "windows": traced},
         output_mean=float(arr.mean()), output_std=float(arr.std()), crop_tol=f"{ZOO_TOL}*max(1,|cpu|)", crops=crops)
    return k8


def writeDraw(work, step, draw, seed):
    """A model's seeded full-width draw, saved where the registry looks for its checkpoint."""
    sd = draw(seed)
    path = os.path.join(work, zooEntry(step)["path"][len("model/"):])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd


def runZoo(seed, work):
    """Every other model of the zoo once through its registry entry's
    ModelExec on the card in bf16 (as ``cli image`` calls it): the output
    finite and of the expected size, K8 launched by NAFNet's entries and
    no other hand-written kernel but K7; each model's fp32 crop against the
    CPU."""
    from moephoto_tpu_torch.config import config

    report = {}
    for i, (name, (step, draw, (w, h), side)) in enumerate(zooModels().items()):
        if name in ("MPRNet_denoising", "NAFNet_32"):
            continue
        sd = writeDraw(work, step, draw, seed + i)
        img = seededImage(seed + 20 + i, w, h)
        entry, ex = zooEntry(step), zooExec(step)
        x = torch.from_numpy(img).cuda().float() / 255.0
        resetCounts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = ex(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = readCounts()
        sc = int(entry["spec"].scale)
        if tuple(y.shape) != (h * sc, w * sc, 3) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: output {tuple(y.shape)} finite {bool(torch.isfinite(y).all())}, "
                                 f"want {(h * sc, w * sc, 3)}")
        others = sum(v for k, v in launches.items() if k not in ("blendTiles", "layerNorm"))  # K7: any model's
        if others or bool(launches["layerNorm"]) != name.startswith("NAFNet"):
            raise AssertionError(f"{name} launched {launches}: K8 in NAFNet's entries alone, no other wanted")
        report[name] = {"step": step, "input": [h, w, 3], "output": list(y.shape), "first_call_seconds": seconds,
                        "dtype": str(config.dtype()), "output_mean": float(y.mean()), "output_std": float(y.std()),
                        "crop": holdZooCrop(name, step, sd, img, side)}
        del sd, y
    emit(phase="zoo", launches="K8 in NAFNet's entries, none in the others; K7 blends the tiles",
         crop_tol=f"{ZOO_TOL}*max(1,|cpu|)",
         models=report)


def tileMacs(ctor, tile):
    """Multiply-accumulates of one (1, tile, tile, 3) tile through the model
    ``ctor()`` builds, by layer group: every conv, ConvTranspose and linear
    (layerMacs' hooks) and both products of each attention
    (``demoire.attend``, from its shapes).  Built and run on the meta
    device, so nothing is computed or allocated."""
    from moephoto_tpu_torch.models import demoire

    plain, counted = demoire.attend, {"attention": 0}

    def attend(q, k, v):
        counted["attention"] += q.shape[0] * q.shape[1] * k.shape[1] * (q.shape[2] + v.shape[2])
        return plain(q, k, v)

    with torch.device("meta"):
        model = ctor().eval()
        x = torch.empty(1, tile, tile, 3)
    demoire.attend = attend
    try:
        with torch.no_grad():  # a count records no graph (K8 refuses one)
            byLayer = layerMacs(model, lambda: model(x))
    finally:
        demoire.attend = plain
    return {**byLayer, **counted}


def imageMacs(entry, w, h):
    """Multiply-accumulates of one w x h image through a registry entry's
    tiled ModelExec: a tile's, times the tiles its chunks run (the last
    chunk filled up to the batch, as the engine runs it)."""
    from moephoto_tpu_torch.engine.tiling import planAxis
    from moephoto_tpu_torch.pipeline import registry

    spec = entry["spec"]
    tiles = len(planAxis(h, spec.tile, spec.pad)) * len(planAxis(w, spec.tile, spec.pad))
    run = -(-tiles // spec.batch) * spec.batch
    perTile = tileMacs(getattr(registry._lazyImport(entry["family"]), entry["fn"]), spec.tile)
    return run * sum(perTile.values()), {k: run * v for k, v in perTile.items()}, tiles, run


ZOO_TIMED = (  # name, registry keys in turn, input (w, h)
    ("NAFNet_32_1080p", ("NAFNet_32",), (W, H)),
    ("MPRNet_deblurring_1080p", ("MPRNet_deblurring",), (W, H)),
    ("config3_chain_1080p", ("MPRNet_denoising", "NAFNet_32"), (W, H)),
    ("gan4_640x360", ("gan4",), (640, 360)),
    ("moire_obj_1080p", ("moire_obj",), (W, H)),
    ("moire_screen_gan_1080p", ("moire_screen_gan",), (W, H)),
)


def timingZoo(seed, gpu):
    """Input Mpx/s of NAFNet-32, MPRNet deblur, the config-3 chain, gan4 and
    both moire models on a device-resident image (bf16, mean of ITERS by
    CUDA events after WARMUP), their multiply-accumulates an image
    (imageMacs), and one profiled call: device ms, idle share, the achieved
    rate, top kernels."""
    models = zooModels()
    g = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for name, keys, (w, h) in ZOO_TIMED:
        t0 = time.perf_counter()
        execs = [(zooEntry(models[k][0]), zooExec(models[k][0])) for k in keys]
        x = torch.rand((h, w, 3), generator=g, device="cuda")

        def fn():
            y = x
            for _, ex in execs:
                y = ex(y)
            return y

        y = fn()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: output not finite")
        for _ in range(WARMUP):
            fn()
        ms = cudaTimeMs(fn, ITERS)
        timedS = time.perf_counter() - t0
        wallMs, rows = profileOnce(fn)
        deviceMs = sum(t for _, t in rows)
        profiledS = time.perf_counter() - t0 - timedS
        macs, byLayer, tiles = 0, {}, []
        for entry, _ in execs:
            m, layers, n, run = imageMacs(entry, w, h)
            macs += m
            tiles.append([n, run])
            for k, v in layers.items():
                byLayer[k] = byLayer.get(k, 0) + v
        top = sorted(byLayer.items(), key=lambda kv: -kv[1])[:6]
        report[name] = {"input": [h, w, 3], "mpx_per_s": (h * w / 1e6) / (ms / 1e3), "ms_per_image": ms,
                        "iters": ITERS, "profiled_wall_ms": wallMs, "profiled_device_ms": deviceMs,
                        "device_idle_share": (1 - deviceMs / wallMs) if wallMs else None,
                        "gmac_per_image": macs / 1e9, "tflops_achieved": 2 * macs / (deviceMs * 1e-3) / 1e12,
                        "tiles_planned_and_run": tiles, "mac_share": {k: v / macs for k, v in top},
                        "top_kernels": [{"name": k[:80], "ms": t} for k, t in rows[:8]],
                        "seconds": {"timed": timedS, "profiled": profiledS}}
    emit(phase="zoo_timing", gpu=gpu, dtype="bfloat16", warmup=WARMUP, paths=report)


# --- the multi-device serving layer on the one card ---------------------------

MESH_SIZES = (2, 4)  # row shards of cuda:0 in the mesh phase
# slomo on a mesh vs the single-device card run: 16-bit output values
MESH_VIDEO_LSB = 1
# the 128x128 slomo crop in fp32 (TF32 off) on a mesh vs the single-device card run: the same
# kernels on the same rows; the mean sums per shard and cuDNN picks algorithms per shape
MESH_CROP_TOL = 2e-5
MESH_CROP_RTOL = 1e-5  # with MESH_CROP_TOL, the JAX package's sharded-stage tolerance (tests/test_parallel.py)
# a second resolution for slomo on a mesh: IFRNet gathers its segments at 1/8 of the rows and
# coarser (GATHER_FROM_LEVEL), at 2160p 270 rows and fewer
UHD, UHD_FRAMES = (3840, 2160), 5
FAR_ROWS = 150.0  # the largest |flow| of mesh_kernels' stretched propWarp case: over a [2] or [4] shard's rows


def cardMesh(n):
    from moephoto_tpu_torch.parallel.mesh import makeMesh

    return makeMesh([n], devices=[torch.device("cuda", 0)] * n)


def cardShards(t, n, align=1):
    from moephoto_tpu_torch.parallel.sharded import RowShards

    return RowShards.split(t, [torch.device("cuda", 0)] * n, 1, align)


def resetMeshCounts():
    from moephoto_tpu_torch.ops.deform import deformConv2dSpmd
    from moephoto_tpu_torch.ops.lut import ailutTransformSpmd
    from moephoto_tpu_torch.ops.warp import warpSpmd
    from moephoto_tpu_torch.parallel import sharded

    warpSpmd.launches = deformConv2dSpmd.launches = ailutTransformSpmd.launches = 0
    sharded.resetStats()


def readMeshCounts():
    from moephoto_tpu_torch.ops.deform import deformConv2dSpmd
    from moephoto_tpu_torch.ops.lut import ailutTransformSpmd
    from moephoto_tpu_torch.ops.warp import warpSpmd
    from moephoto_tpu_torch.parallel import sharded

    return {"warpSpmd": warpSpmd.launches, "deformConv2dSpmd": deformConv2dSpmd.launches,
            "ailutTransformSpmd": ailutTransformSpmd.launches, "gathered_segments": sharded.stats["gathers"],
            "host_reads": sharded.stats["hostReads"], "halo_bytes": sharded.stats["haloBytes"],
            "tile_calls_by_slot": dict(sharded.stats["tileCalls"])}


class Meshed:
    """While entered, ``mesh`` is the active mesh (None: single device)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from moephoto_tpu_torch.parallel.mesh import installMesh

        installMesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        from moephoto_tpu_torch.parallel.mesh import installMesh

        installMesh(None)
        return False


class FrameCapture:
    """While installed (it wraps ``video.engine.prepare``): every raw frame
    the video path sends to the encoder."""

    def __enter__(self):
        from moephoto_tpu_torch.video import engine

        self.module, self.orig, self.frames = engine, engine.prepare, []

        def prepare(*args):
            p = self.orig(*args)
            process = p["process"]

            def record(item):
                bufs = process(item)
                self.frames.extend(b for b in bufs or () if b)
                return bufs

            p["process"] = record
            return p

        engine.prepare = prepare
        return self

    def __exit__(self, *exc):
        self.module.prepare = self.orig
        return False


def holdEqual(errs, key, got, want):
    """Bit-equality, NaN where ``want`` is NaN; the largest difference
    (0.0) goes into ``errs``."""
    nan = torch.isnan(want)
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{key}: shape, type or NaNs differ from the single-device kernel")
    errs[key] = float((got.float() - want.float()).abs()[~nan].max()) if (~nan).any() else 0.0
    if errs[key] != 0.0:
        raise AssertionError(f"{key}: {errs[key]} from the single-device kernel, want bit-equal")


def checkMeshKernels(seed, warpInputs, vsrWarps, dcnInputs, lutInput, lutModel):
    """K2a, K3's tier and K6 on cuda:0 x 2 and x 4 against the single-device
    kernels, bit-equal: the warp at IFRNet-M's four 1080p shapes on the
    inputs the video phase recorded, fp32 and bf16, both modes, and on
    flows that span several shards; backWarp at IFRNet's 1/2 level and on
    what IconVSR's warps were given in the vsr phase (SpyNet's six levels,
    bf16, border; ``propWarp``, 64 channels fp32, zeros, also with its
    scan's row reach passed as ``reach``, as the sharded scans do, and by
    its flow stretched to FAR_ROWS rows with that reach); the DCN at EDVR's three
    640x360 shapes on the offsets the vsr phase recorded, bf16 and fp32
    (TF32 off); the AiLUT transform at 1080p on the retouch chain's input."""
    from moephoto_tpu_torch.ops.deform import deformConv2d, deformConv2dSpmd
    from moephoto_tpu_torch.ops.lut import ailutTransform, ailutTransformSpmd
    from moephoto_tpu_torch.ops.warp import backWarp, backWarpSpmd, rowReach, warp, warpSpmd

    with torch.inference_mode():
        _, table, vertices = lutModel.generate(lutInput)
    spans = {"spans_136x240x72_bfloat16": warpCase(seed + 70, 1, 136, 240, 72, torch.bfloat16, torch.bfloat16, 80.0),
             "spans_1088x1920x3_float32": warpCase(seed + 71, 1, 1088, 1920, 3, torch.float32, torch.float32, 600.0)}
    errs, reach = {}, {}
    for n in MESH_SIZES:
        resetMeshCounts()
        for key, (img, flow) in list(warpInputs.items()) + list(spans.items()):
            other = torch.float32 if img.dtype == torch.bfloat16 else torch.bfloat16
            for x in (img, img.to(other)):
                for mode in ("border", "zeros"):
                    got = warpSpmd(cardShards(x, n), cardShards(flow, n), mode).gather()
                    holdEqual(errs, f"warpSpmd_{n}_{key}_{str(x.dtype)[6:]}_{mode}", got, warp(x, flow, mode))
            reach[f"{n}_{key}"] = int(flow.float().abs().nan_to_num(0.0).max().ceil()) + 1
        img, flow = warpInputs["544x960x32_bfloat16"]
        holdEqual(errs, f"backWarpSpmd_{n}_544x960x32", backWarpSpmd(cardShards(img, n), cardShards(flow, n)).gather(),
                  backWarp(img, flow))
        for key, (img, flow, mode, scanReach) in vsrWarps.items():
            si, sf, want = cardShards(img, n), cardShards(flow, n), backWarp(img, flow, mode)
            holdEqual(errs, f"backWarpSpmd_{n}_vsr_{key}", backWarpSpmd(si, sf, mode).gather(), want)
            if scanReach is not None:
                holdEqual(errs, f"backWarpSpmd_{n}_vsr_{key}_scan_reach",
                          backWarpSpmd(si, sf, mode, scanReach).gather(), want)
                # the random model's flows move less than a row: the same warp by its flow stretched to
                # FAR_ROWS rows, across shards, with that reach passed as a scan passes its own
                far = flow * (FAR_ROWS / flow.float().abs().nan_to_num(0.0).amax().clamp_min(1e-6))
                holdEqual(errs, f"backWarpSpmd_{n}_vsr_{key}_far_reach",
                          backWarpSpmd(si, cardShards(far, n), mode, rowReach([far], 1)).gather(),
                          backWarp(img, far, mode))
        for lv in ("l3", "l2", "l1"):
            x, off, mask, weight, bias, dg = dcnInputs[lv]
            for xd in (x, x.float()):
                got = deformConv2dSpmd(cardShards(xd, n), cardShards(off, n), cardShards(mask, n), weight, bias, dg)
                holdEqual(errs, f"deformConv2dSpmd_{n}_{lv}_{str(xd.dtype)[6:]}", got.gather(),
                          deformConv2d(xd, off, mask, weight, bias, dg))
        holdEqual(errs, f"ailutTransformSpmd_{n}_1080p", ailutTransformSpmd(cardShards(lutInput, n), table,
                                                                            vertices).gather(),
                  ailutTransform(lutInput.contiguous(), table, vertices))
        counts = readMeshCounts()
        cases = len(warpInputs) + len(spans)
        vsrCases = len(vsrWarps) + 2 * sum(r is not None for *_, r in vsrWarps.values())
        want = {"warpSpmd": n * (cases * 4 + 1 + vsrCases), "deformConv2dSpmd": n * 6, "ailutTransformSpmd": n}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"mesh kernels on {n} shards launched {counts}, want {want}")
    torch.cuda.synchronize()
    emit(phase="mesh_kernels", shards=list(MESH_SIZES), tol="bit-equal (0.0)", cases=len(errs),
         max_abs_err=max(errs.values()), warp_reach_rows=reach, dcn_shapes={lv: list(dcnInputs[lv][0].shape)
                                                                            for lv in ("l3", "l2", "l1")},
         vsr_warps={k: dict(img=list(img.shape), flow=list(flow.shape), mode=mode, scan_reach_rows=r,
                            flow_reach_rows=int(flow.float().abs().nan_to_num(0.0).max().ceil()))
                    for k, (img, flow, mode, r) in vsrWarps.items()},
         ailut_input=list(lutInput.shape))
    return max(errs.values())


def runMeshImage(work, n, want):
    """``cli image`` lite x4 on the 1080p PNG of the main phase under the
    [n] mesh (one replica a device): the 7680x4320 output within 1 LSB of
    the main phase's, K1 launched by every mesh slot."""
    from PIL import Image

    from moephoto_tpu_torch import cli

    src, dst = os.path.join(work, "in.png"), os.path.join(work, f"mesh{n}_out.png")
    with Meshed(cardMesh(n)):
        resetCounts()
        resetMeshCounts()
        t0 = time.perf_counter()
        cli.runImage(src, dst, STEPS)
        seconds = time.perf_counter() - t0
        launches, mesh = readCounts(), readMeshCounts()
    with Image.open(dst) as out:
        got = np.asarray(out).astype(np.int32)
    lsb = int(np.abs(got - want.astype(np.int32)).max()) if got.shape == want.shape else None
    slots = mesh["tile_calls_by_slot"]
    if lsb is None or lsb > 1 or launches["fusedUpHeads"] != 4 or slots != {j: 4 // n for j in range(n)}:
        raise AssertionError(f"mesh image on {n}: shape {got.shape}, {lsb} LSB from the main phase, "
                             f"launches {launches}, model calls by slot {slots}")
    emit(phase="mesh_image", shards=n, steps=STEPS, output=list(got.shape), seconds=seconds, launches=launches,
         fusedUpHeads_by_slot=slots, max_lsb_vs_single=lsb, share_differing=float((got != want).mean()))


def runSingleVideo(work, size, count):
    """``cli video`` IFRNet-M slomo x2, single-device, on ``count`` frames of
    ``size`` (w, h): the raw frames sent to the encoder."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = "%dx%d" % size, str(count)
    with FrameCapture() as cap:
        _, frames = cli.runVideo(os.path.join(work, "in.mkv"), os.path.join(work, "single_%dx%d.mkv" % size), SLOMO)
    if frames != count or len(cap.frames) != 2 * count - 1:
        raise AssertionError(f"video at {size}: {frames} frames in, {len(cap.frames)} out")
    return [np.frombuffer(b, np.uint16) for b in cap.frames]


def runMeshVideo(work, n, single, size=(W, H), count=VIDEO_FRAMES):
    """``cli video`` IFRNet-M slomo x2 on ``count`` frames of ``size`` (the
    video phase's 9 frames at 1080p by default) under the [n] mesh:
    2 count - 1 frames, each 16-bit value within MESH_VIDEO_LSB of the
    single-device run; K2a's launches, the gathered segments and the host
    reads of the reach counted."""
    from moephoto_tpu_torch import cli

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = "%dx%d" % size, str(count)
    with Meshed(cardMesh(n)), FrameCapture() as cap:
        resetCounts()
        resetMeshCounts()
        t0 = time.perf_counter()
        path, frames = cli.runVideo(os.path.join(work, "in.mkv"), os.path.join(work, f"slomo{n}.mkv"), SLOMO)
        seconds = time.perf_counter() - t0
        launches, mesh = readCounts(), readMeshCounts()
    got = [np.frombuffer(b, np.uint16).astype(np.int32) for b in cap.frames]
    pairs = count - 1
    if frames != count or len(got) != len(single) or len(single) != 2 * count - 1:
        raise AssertionError(f"mesh video on {n}: {frames} frames in, {len(got)} out, want {len(single)}")
    single = [f.astype(np.int32) for f in single]
    lsb = [int(np.abs(a - b).max()) for a, b in zip(got, single)]
    if max(lsb) > MESH_VIDEO_LSB or mesh["warpSpmd"] != 8 * pairs * n or launches["warp"] != 8 * pairs * n:
        raise AssertionError(f"mesh video on {n}: {lsb} LSB by frame, launches {launches}, mesh {mesh}")
    emit(phase="mesh_video", shards=n, steps=SLOMO, size=list(size), frames_out=len(got), seconds=seconds,
         launches=launches,
         mesh=mesh, max_lsb_by_frame=lsb, tol_lsb=MESH_VIDEO_LSB,
         share_differing=float(np.mean([(a != b).mean() for a, b in zip(got, single)])))
    return mesh["warpSpmd"]


def checkMeshVideoCrop(seed):
    """The slomo stream on 5 frames of 128x128, IFRNet-M in fp32 (TF32 off),
    on the card under [2] and [4] against the single-device card run, every
    segment whose shards hold its reach run sharded (``GATHER_FROM_LEVEL`` 5, so
    the halos of every level are held on the card)."""
    from moephoto_tpu_torch.models import ifrnet
    from moephoto_tpu_torch.parallel import sharded

    frames = np.random.RandomState(seed + 5).rand(5, 128, 128, 3).astype(np.float32)
    opt = ifrnet.getOpt(dict(SLOMO[0]), torch.device("cuda"), torch.float32)
    outs, errs, gathers, shipped = {}, {}, {}, ifrnet.GATHER_FROM_LEVEL
    try:
        ifrnet.GATHER_FROM_LEVEL = 5
        for n in (None,) + MESH_SIZES:
            with Meshed(cardMesh(n) if n else None):
                sharded.resetStats()
                f = slomoStream(opt, lambda x: x.cpu())
                got = []
                for fr in frames:
                    got += f(torch.from_numpy(fr).cuda())
                got += f(None)
            outs[n] = torch.stack(got)
            if n:
                errs[n], gathers[n] = float((outs[n] - outs[None]).abs().max()), sharded.stats["gathers"]
    finally:
        ifrnet.GATHER_FROM_LEVEL = shipped
    if outs[None].shape != (9, 128, 128, 3) or max(errs.values()) > MESH_CROP_TOL:
        raise AssertionError(f"mesh video crop: {tuple(outs[None].shape)}, mesh vs single {errs}")
    emit(phase="mesh_video_crop", shape=list(outs[None].shape), max_abs_err_by_shards=errs, tol=MESH_CROP_TOL,
         gathered_segments_by_shards=gathers)


def runMeshModel(work, n, single, name, steps, size, count, wantOut):
    """``cli video`` with ``steps`` (IconVSR x4 or ESTRNN) on ``count`` frames
    of ``size`` (w, h) under the [n] mesh: the frames each within
    MESH_VIDEO_LSB of the single-device run ``single``; K3's tier and K2a
    launches, the gathered segments and the host reads counted.  Every
    segment the shipped rules run sharded is run whole as well
    (``sharded.checkingSegments``; its seconds include that) and must not
    round a bit apart from it: the bf16 rounding the gather rules guard
    against."""
    from moephoto_tpu_torch import cli
    from moephoto_tpu_torch.parallel import sharded

    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = "%dx%d" % size, str(count)
    with Meshed(cardMesh(n)), FrameCapture() as cap, sharded.checkingSegments():
        resetCounts()
        resetMeshCounts()
        t0 = time.perf_counter()
        _, frames = cli.runVideo(os.path.join(work, "in.mkv"), os.path.join(work, f"{name}{n}.mkv"), steps)
        seconds = time.perf_counter() - t0
        launches, mesh, segments = readCounts(), readMeshCounts(), dict(sharded.stats["segments"])
    got = [np.frombuffer(b, np.uint16).astype(np.int32) for b in cap.frames]
    if frames != count or len(got) != len(single) or len(single) != wantOut:
        raise AssertionError(f"mesh {name} on {n}: {frames} frames in, {len(got)} out, want {wantOut}")
    lsb = [int(np.abs(a - b.astype(np.int32)).max()) for a, b in zip(got, single)]
    differing = {k: v for k, v in segments.items() if v[1]}
    if max(lsb) > MESH_VIDEO_LSB or differing or not segments:
        raise AssertionError(f"mesh {name} on {n}: {lsb} LSB by frame, launches {launches}, mesh {mesh}, "
                             f"{len(segments)} sharded segments checked, rounding apart from the whole: {differing}")
    emit(phase=f"mesh_{name}", shards=n, steps=steps, size=list(size), frames_out=len(got), seconds=seconds,
         launches=launches, mesh=mesh, max_lsb_by_frame=lsb, tol_lsb=MESH_VIDEO_LSB,
         share_differing=float(np.mean([(a != b).mean() for a, b in zip(got, single)])),
         sharded_segments_checked={k: v[0] for k, v in segments.items()}, sharded_segments_differing=differing)
    return launches, mesh


def runMeshVsr(work, n, single, edvrCalls):
    """IconVSR x4 on the vsr phase's 22 frames of 640x360 under [n]: every EDVR
    call's four DCNs through K3's tier (n launches each), SpyNet's and the
    recurrences' warps through K2a."""
    launches, mesh = runMeshModel(work, n, single, "vsr", VSR, (VSR_W, VSR_H), VSR_FRAMES, VSR_FRAMES)
    if mesh["deformConv2dSpmd"] != 4 * edvrCalls * n or mesh["warpSpmd"] == 0:
        raise AssertionError(f"mesh vsr on {n}: launches {launches}, mesh {mesh}, want {4 * edvrCalls * n} "
                             "DCN launches through K3's tier and K2a launches")
    return mesh["deformConv2dSpmd"], mesh["warpSpmd"]


def runMeshDemob(work, n, single):
    """ESTRNN on the demob phase's 9 frames of 1280x720 under [n]."""
    launches, mesh = runMeshModel(work, n, single, "demob", DEMOB, (DEMOB_W, DEMOB_H), DEMOB_FRAMES, DEMOB_FRAMES)
    if sum(launches.values()):
        raise AssertionError(f"mesh demob on {n} launched {launches}: ESTRNN has no kernel of its own")


def closeTo(got, want, atol, rtol):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def checkMeshModelCrops(seed):
    """IconVSR's VSR stream on 9 frames of 128x128 and ESTRNN's deblur stream on
    6 frames of 128x128, fp32 (TF32 off), on the card under [2] against the
    single-device card run: within MESH_CROP_TOL abs / MESH_CROP_RTOL rel."""
    from moephoto_tpu_torch.models import estrnn, iconvsr
    from moephoto_tpu_torch.parallel import sharded

    rng = np.random.RandomState(seed + 8)
    clips = {"vsr": [torch.from_numpy(f).cuda() for f in rng.rand(9, 128, 128, 3).astype(np.float32)],
             "demob": [torch.from_numpy(f).cuda() for f in rng.rand(6, 128, 128, 3).astype(np.float32)]}
    opts = {"vsr": iconvsr.getOpt({}, torch.device("cuda"), torch.float32),
            "demob": estrnn.getOpt(dict(DEMOB[0]), torch.device("cuda"), torch.float32)}
    run = {"vsr": lambda o, c: feedClip(o, c, lambda x: x.cpu()),
           "demob": lambda o, c: feedDeblur(o, c, lambda x: x.cpu())}
    report = {}
    for name in ("vsr", "demob"):
        single = torch.stack(run[name](opts[name], clips[name]))
        with Meshed(cardMesh(2)):
            sharded.resetStats()
            multi = torch.stack(run[name](opts[name], clips[name]))
            gathers = sharded.stats["gathers"]
        err = float((multi - single).abs().max())
        if multi.shape != single.shape or not closeTo(multi, single, MESH_CROP_TOL, MESH_CROP_RTOL):
            raise AssertionError(f"mesh {name} crop: {tuple(multi.shape)}, {err} from single-device")
        report[name] = dict(shape=list(multi.shape), max_abs_err=err, gathered_segments=gathers)
    emit(phase="mesh_model_crops", shards=2, tol=f"{MESH_CROP_TOL} abs, {MESH_CROP_RTOL} rel", **report)


def timingMeshModels(seed, gpu):
    """IconVSR's input Mpx/s on a device-resident 22-frame 640x360 clip and
    ESTRNN's output Mpx/s on device-resident 720p frames (DEMOB_WARM then 24
    timed), by CUDA events, sharded against single-device in turns (single,
    2, 4, single); with each run's K3-tier and K2a launches, gathered
    segments and host reads."""
    from moephoto_tpu_torch.models import estrnn, iconvsr

    g = torch.Generator(device="cuda").manual_seed(seed)
    clip = [torch.rand((VSR_H, VSR_W, 3), generator=g, device="cuda") for _ in range(VSR_FRAMES)]
    frames = [torch.rand((DEMOB_H, DEMOB_W, 3), generator=g, device="cuda") for _ in range(8)]
    vsrOpt, demobOpt = iconvsr.getOpt({}), estrnn.getOpt(dict(DEMOB[0]))

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        resetMeshCounts()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3, readMeshCounts()

    rows = {"vsr": [], "demob": []}
    for n in (None,) + MESH_SIZES + (None,):
        with Meshed(cardMesh(n) if n else None):
            feedClip(vsrOpt, clip, lambda x: x.mean())  # warm-up: cuDNN's first calls at the shards' shapes
            out, sec, counts = timed(lambda: len(feedClip(vsrOpt, clip, lambda x: x.mean())))
            rows["vsr"].append(dict(shards=n or 1, frames=out, seconds_events=sec, mesh=counts,
                                    input_mpx_per_s=VSR_FRAMES * VSR_H * VSR_W / 1e6 / sec))
            feed = deblurFeeder(demobOpt, frames)
            feed(DEMOB_WARM)
            out, sec, counts = timed(lambda: feed(24))
            rows["demob"].append(dict(shards=n or 1, frames=out, seconds_events=sec, mesh=counts,
                                      output_mpx_per_s=out * DEMOB_H * DEMOB_W / 1e6 / sec))
    emit(phase="mesh_model_timing", gpu=gpu, vsr_640x360=rows["vsr"], demob_1280x720=rows["demob"],
         note="one card: the cost of sharding (halo copies, per-shard launches, host reads), not scaling")


class HaloTimer:
    """While installed: CUDA events around every row window a shard takes
    (``RowShards.window``: the halo exchange), by IFRNet stage."""

    def __enter__(self):
        from moephoto_tpu_torch.models.ifrnet import IFRNet
        from moephoto_tpu_torch.parallel.sharded import RowShards

        self.RowShards, self.IFRNet = RowShards, IFRNet
        self.window, self.encode, self.decode = RowShards.window, IFRNet.encodeFull, IFRNet.decodePost
        self.events, self.stage = {}, None

        def window(rs, j, lo, hi):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.window(rs, j, lo, hi)
            e.record()
            self.events.setdefault(self.stage, []).append((s, e))
            return out

        def staged(name, fn):
            def call(*args, **kw):
                self.stage = name
                try:
                    return fn(*args, **kw)
                finally:
                    self.stage = None
            return call

        RowShards.window = window
        IFRNet.encodeFull, IFRNet.decodePost = staged("encode", self.encode), staged("decode", self.decode)
        return self

    def __exit__(self, *exc):
        self.RowShards.window = self.window
        self.IFRNet.encodeFull, self.IFRNet.decodePost = self.encode, self.decode
        return False

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


def shardWarpBound(imgWin, flow):
    """Least time for one shard's warp: its image window read once, its
    flow read once, its output written once (as warpBound)."""
    B, h, w, c = flow.shape[:3] + imgWin.shape[3:]
    images = 1 if imgWin.stride(0) == 0 else B
    nbytes = (images * imgWin.shape[1] + B * h) * w * c * imgWin.element_size() + flow.numel() * flow.element_size()
    tBytes = nbytes / PEAK_BYTES * 1e3
    tOps = B * h * w * (WARP_FLOP_PER_VALUE * c + WARP_FLOP_PER_PX) / PEAK_FP32_FLOPS * 1e3
    return max(tOps, tBytes), ("operations" if tOps > tBytes else "bytes")


def shardDcnBound(xWin, off, mask, cout):
    """Least time for one shard's DCN: its window of x read once, its
    offsets and mask read once, its output written once (as dcnBound)."""
    B, h, w = off.shape[:3]
    c, px = xWin.shape[-1], B * h * w
    nbytes = (xWin.numel() * xWin.element_size() + px * (off.shape[-1] * off.element_size()
              + mask.shape[-1] * mask.element_size() + cout * xWin.element_size()) + 9 * c * cout * xWin.element_size())
    peak = PEAK_BF16_FLOPS if xWin.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tOps, tBytes = 2 * 9 * c * cout * px / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(tOps, tBytes), ("operations" if tOps > tBytes else "bytes")


def shardGridSampleMs(imgWin, flow, top, mode="border"):
    """Device ms of ``F.grid_sample`` (bilinear, ``mode`` padding,
    align_corners) on one shard's halo window ``imgWin`` at the shard's
    flow, its rows ``top`` rows into the window: the library call that
    computes the shard's warp."""
    import torch.nn.functional as F

    B, h, w = flow.shape[:3]
    hw = imgWin.shape[1]
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device) + top, torch.arange(w, device=flow.device),
                            indexing="ij")
    grid = torch.stack([2 * (xs + flow[..., 0].float()) / (w - 1) - 1,
                        2 * (ys + flow[..., 1].float()) / (hw - 1) - 1], -1).to(imgWin.dtype)
    nchw = imgWin.permute(0, 3, 1, 2)
    return cudaTimeMs(lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode=mode, align_corners=True),
                      ITERS)


def shardWindows(shards, reach):
    return [shards.window(j, max(0, a - reach), min(shards.rows, b + reach))
            for j, (a, b) in enumerate(zip(shards.bounds, shards.bounds[1:]))]


def timingMesh(seed, gpu, warpInputs, vsrWarps, dcnInputs, lutInput, lutModel):
    """Sharded against single-device on the one card, in turns (single, 2,
    4, single): slomo output Mpx/s on device-resident 1080p frames with the
    halo exchange's ms per stage (the device clock from before the first
    row window a shard takes to after it: the copies, and the host's time
    in between wherever the device waited for it) and a profiled chunk's
    device ms and idle share, and lite x4 input Mpx/s through
    ModelExec; then each sharded kernel's per-shard median launch at its
    shapes beside the mean per-shard bound (the single-device kernel's bytes
    plus the halo's, over the shards) and the plain version on one shard:
    the warp at IFRNet-M's four 1080p shapes and at IconVSR's warps that run
    sharded (SpyNet's two finest levels, ``propWarp``; their flows folded as
    ``backWarpSpmd`` folds them)."""
    from moephoto_tpu_torch.models.ifrnet import getOpt
    from moephoto_tpu_torch.ops.deform import dcnRowReach, deformConv2dPlain, deformConv2dSpmd
    from moephoto_tpu_torch.ops.lut import ailutTransformPlain, ailutTransformSpmd
    from moephoto_tpu_torch.ops.warp import backWarpFlow, rowReach, warpPlain, warpSpmd
    from moephoto_tpu_torch.pipeline import registry

    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = [torch.rand((H, W, 3), generator=g, device="cuda") for _ in range(4)]
    opt = getOpt(dict(SLOMO[0]))
    slomo = []
    for n in (None,) + MESH_SIZES + (None,):
        with Meshed(cardMesh(n) if n else None):
            f = slomoStream(opt, lambda x: x.mean())
            feed = lambda k: sum(len(f(frames[i % 4])) for i in range(k))  # noqa: E731
            feed(16)
            torch.cuda.synchronize()
            resetMeshCounts()
            with HaloTimer() as halo:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = feed(16)
                end.record()
                torch.cuda.synchronize()
                wallS = time.perf_counter() - t0
                haloMs = halo.ms()
            eventS = start.elapsed_time(end) / 1e3
            counts = readMeshCounts()
            wallMs, rows = profileOnce(lambda: feed(8))  # one chunk: 8 pairs
            deviceMs = sum(t for _, t in rows)
            slomo.append(dict(shards=n or 1, output_frames=out, output_mpx_per_s=out * H * W / 1e6 / eventS,
                              seconds_events=eventS, seconds_wall=wallS, mesh=counts,
                              halo_exchange_ms_per_chunk={k: v / 2 for k, v in haloMs.items() if k},
                              profiled_chunk_wall_ms=wallMs, profiled_chunk_device_ms=deviceMs,
                              device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
                              top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:8]]))
    ex = registry.getSR({"model": "lite", "scale": UPSCALE})
    x = torch.rand((H, W, 3), generator=g, device="cuda")
    lite = []
    for n in (None,) + MESH_SIZES + (None,):
        with Meshed(cardMesh(n) if n else None):
            for _ in range(WARMUP):
                ex(x)
            ms = cudaTimeMs(lambda: ex(x), ITERS)
        lite.append(dict(shards=n or 1, input_mpx_per_s=H * W / 1e6 / (ms / 1e3), ms_per_image=ms))
    emit(phase="mesh_timing", gpu=gpu, slomo=slomo, lite_x4=lite,
         note="one card: the cost of sharding (halo copies, per-shard launches, host reads), not scaling")

    kernels = {}
    warpCases = {key: (img, flow, "border") for key, (img, flow) in warpInputs.items()}
    fullRows = max(img.shape[1] for img, *_ in vsrWarps.values())
    warpCases.update({f"vsr_{key}": (img, backWarpFlow(flow), mode) for key, (img, flow, mode, _) in vsrWarps.items()
                      if 4 * img.shape[1] > fullRows})  # IconVSR gathers the levels at 1/4 of the rows and coarser
    for n in MESH_SIZES:
        for key, (img, flow, mode) in warpCases.items():
            si, sf = cardShards(img, n), cardShards(flow, n)
            reach = rowReach(sf.parts, 1) + 1
            wins = shardWindows(si, reach)
            bounds = [shardWarpBound(wv, fp) for wv, fp in zip(wins, sf.parts)]
            ms, rec = medianLaunchMs(lambda: warpSpmd(si, sf, mode), isWarpKernel)
            a = si.bounds[0]
            plainMs = cudaTimeMs(lambda: warpPlain(wins[0], sf.parts[0], mode, (a, 0, si.rows)), 3)
            libMs = sum(shardGridSampleMs(wv, fp, a - max(0, a - reach), mode)
                        for wv, fp, a in zip(wins, sf.parts, si.bounds)) / n
            kernels[f"warpSpmd_{n}_{key}"] = dict(ms=ms, recorded=rec, plain_ms=plainMs, halo_rows=reach,
                                                  bound_ms=sum(b for b, _ in bounds) / n, bound_by=bounds[0][1],
                                                  library_ms=libMs)
        for lv in ("l3", "l2", "l1"):
            x, off, mask, weight, bias, dg = dcnInputs[lv]
            sx, so, sm = cardShards(x, n), cardShards(off, n), cardShards(mask, n)
            reach = dcnRowReach(so.parts)
            wins = shardWindows(sx, reach)
            bounds = [shardDcnBound(wv, o, m, weight.shape[0]) for wv, o, m in zip(wins, so.parts, sm.parts)]
            ms, rec = medianLaunchMs(lambda: deformConv2dSpmd(sx, so, sm, weight, bias, dg), isDcnKernel)
            plainMs = cudaTimeMs(lambda: deformConv2dPlain(wins[0], so.parts[0], sm.parts[0], weight, bias, dg,
                                                           rows=(0, 0, sx.rows)), 2)
            kernels[f"deformConv2dSpmd_{n}_{lv}"] = dict(ms=ms, recorded=rec, plain_ms=plainMs, halo_rows=reach,
                                                         bound_ms=sum(b for b, _ in bounds) / n,
                                                         bound_by=bounds[0][1], library_ms=None)
        with torch.inference_mode():
            _, table, vertices = lutModel.generate(lutInput)
        sl = cardShards(lutInput.contiguous(), n)
        parts = [p.contiguous() for p in sl.parts]
        bounds = [lutBound(p, table, vertices) for p in parts]
        ms, rec = medianLaunchMs(lambda: ailutTransformSpmd(sl, table, vertices), isLutKernel)
        plainMs = cudaTimeMs(lambda: ailutTransformPlain(parts[0], table, vertices), 3)
        kernels[f"ailutTransformSpmd_{n}_1080p"] = dict(ms=ms, recorded=rec, plain_ms=plainMs, halo_rows=0,
                                                        bound_ms=sum(b for b, _ in bounds) / n,
                                                        bound_by=bounds[0][1], library_ms=None)
    emit(phase="kernel_timing", gpu=gpu, kernel="warpSpmd+deformConv2dSpmd+ailutTransformSpmd",
         per_shard_median_launch=kernels,
         library="warpSpmd: F.grid_sample on each shard's halo window, mean a shard; none computes a DCN or LUT")
    return kernels


def driveUnpathed(lutInput, lutModel, n=2):
    """K6 through the module that reaches it inside a row-sharded stage, as the
    JAX package's stage traces do: AiLUT's forward under ``spmdTracing()`` on
    the [n] mesh (on no product path: ``applyWhole`` is single-device, as in
    JAX).  Returns its launches in that run; the output is held bit-equal to
    the single-device module's."""
    from moephoto_tpu_torch.parallel import temporal

    with torch.inference_mode():
        want = lutModel(lutInput)
        with Meshed(cardMesh(n)):
            resetMeshCounts()
            temporal._spmdTracing[0] = True
            try:
                got = lutModel(lutInput)
            finally:
                temporal._spmdTracing[0] = False
            counts = readMeshCounts()
    errs = {}
    holdEqual(errs, "AiLUT", got, want)
    if counts["ailutTransformSpmd"] != n:
        raise AssertionError(f"AiLUT under spmdTracing on {n} shards launched {counts}")
    emit(phase="mesh_modules", shards=n, launches=counts, max_abs_err=errs)
    return counts["ailutTransformSpmd"]


# --- the server phase: the two-process app as a user drives it ---------------

SERVER_START_S = 120  # the app answers within this after its start
STOP_REPLY_S = 5  # /stop ends a lockInterface within this
BATCH_W, BATCH_H = 480, 270  # each of the two /batch_enhance images
VIDEO_STEPS = [{"op": "decode"}, {"op": "range"}, *SLOMO, {"op": "output"}]


def recordingFfmpeg(work):
    """An executable that runs the repository's fake ffmpeg and, on an
    encode call (``-i -``), also keeps the raw frames it is sent in
    ``<output>.raw``: the app's frames, read after it ran."""
    path = os.path.join(work, "ffmpeg_rec")
    fake = os.path.join(ROOT, "tools", "fakeffmpeg.py")
    with open(path, "w") as fp:
        fp.write(f'#!/bin/sh\nfor a; do last=$a; done\ncase " $* " in\n'
                 f'  *" -i - "*) tee "$last.raw" | "{sys.executable}" "{fake}" "$@"; exit $? ;;\nesac\n'
                 f'exec "{sys.executable}" "{fake}" "$@"\n')
    os.chmod(path, 0o755)
    return path


def freePort():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multipart(fields, files):
    """A multipart/form-data body: ``files`` is a list of (field, filename, bytes)."""
    import uuid

    boundary = uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{name}"\r\n'
              f'Content-Type: application/octet-stream\r\n\r\n'.encode() + data + b"\r\n" for k, name, data in files]
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def post(port, path, fields, files=(), timeout=600):
    """POST a form to the app on 127.0.0.1: (status, parsed JSON or text,
    client seconds {upload, wait, read, wall}).  ``upload`` ends when the
    body is sent, ``wait`` when the reply's headers arrive."""
    import http.client

    body, ctype = multipart(fields, files)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body, {"Content-Type": ctype})
        t1 = time.perf_counter()
        resp = conn.getresponse()
        t2 = time.perf_counter()
        data = resp.read()
        t3 = time.perf_counter()
    finally:
        conn.close()
    try:
        parsed = json.loads(data)
    except ValueError:
        parsed = data.decode(errors="replace")
    return resp.status, parsed, {"upload": t1 - t0, "wait": t2 - t1, "read": t3 - t2, "wall": t3 - t0}


def get(port, path, timeout=60):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class MsgPoller:
    """While entered: GET /msg for ``session`` on ``path`` again and again,
    keeping every JSON note the app returns with the time it came."""

    def __init__(self, port, session, path):
        import threading
        import urllib.parse

        self.url = "/msg?" + urllib.parse.urlencode({"session": session, "path": path})
        self.port, self.notes, self.done = port, [], threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self):
        while not self.done.is_set():
            status, data = get(self.port, self.url)
            if status == 200 and data:
                note = json.loads(data)
                if isinstance(note, dict):
                    self.notes.append((time.perf_counter(), note))
            elif status != 200:
                time.sleep(0.05)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join(30)
        return False


def procStat(pid):
    """(state, parent pid) of a process from /proc, or None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as fp:
            fields = fp.read().rsplit(")", 1)[1].split()
    except (FileNotFoundError, ProcessLookupError):
        return None
    return fields[0], int(fields[1])


def descendants(pid):
    """Every live process under ``pid``."""
    parents = {}
    for p in os.listdir("/proc"):
        st = procStat(p) if p.isdigit() else None
        if st and st[0] != "Z":
            parents.setdefault(st[1], []).append(int(p))
    out, todo = [], [pid]
    while todo:
        kids = parents.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def cudaContexts():
    """The number of processes holding a CUDA context on the cards."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return len(out.split())


def pngOf(arr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def readPng(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def lsbApart(got, want):
    if got.shape != want.shape:
        return float("inf")
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


def rawFrames(path, count):
    raw = np.fromfile(path, np.uint16)
    if raw.size != count * W * H * 3:
        raise AssertionError(f"{path}: {raw.size} samples, want {count} frames of {W}x{H}x3")
    return list(raw.reshape(count, -1))


def holdFrames(name, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} frames, want {len(want)}")
    lsb = max(lsbApart(g, w) for g, w in zip(got, want))
    if lsb > 1:
        raise AssertionError(f"{name}: frames {lsb} LSB apart, want at most 1")
    return lsb


def runServerApp(work, mainIn, mainOut, videoFrames):
    """``python3 app_torch.py`` in a fresh working directory, as a user starts
    it, with the synth weights of the earlier phases: /systemInfo, two
    /image_enhance of the main phase's PNG (each within 1 LSB of its
    output, a /msg long-poll beside the first), /batch_enhance of two
    images, /video_enhance of the video phase's 9 frames (17 frames, each
    within 1 LSB of its), lockInterface stopped by /stop, a malformed
    request and the one after it; then SIGINT, and neither a process nor
    the shared-memory block may be left."""
    import signal
    from multiprocessing.shared_memory import SharedMemory

    import app_torch

    cwd = os.path.join(work, "app")
    os.makedirs(os.path.join(cwd, ".user"))
    port = freePort()
    with open(os.path.join(cwd, ".user", "config.json"), "w") as fp:
        json.dump({"modelDir": work, "ffmpegPath": recordingFfmpeg(work), "port": port, "device": "cuda",
                   "opsPath": os.path.join(cwd, ".user", "ops.json")}, fp)
    env = dict(os.environ, FAKEFF_SIZE=f"{W}x{H}", FAKEFF_FRAMES=str(VIDEO_FRAMES))
    contextsBefore = cudaContexts()
    logPath = os.path.join(work, "app.log")
    log = open(logPath, "wb")
    t0 = time.perf_counter()
    app = subprocess.Popen([sys.executable, os.path.join(ROOT, "app_torch.py")], cwd=cwd, env=env,
                           stdout=log, stderr=subprocess.STDOUT)
    out, timing, children = {}, {}, []

    def appLog():
        with open(logPath, errors="replace") as fp:
            return fp.read()[-4000:]

    def need(cond, what):
        if not cond:
            raise AssertionError(f"server: {what}\napp log:\n{appLog()}")

    try:
        while True:
            need(app.poll() is None, f"the app exited with {app.returncode}")
            try:
                status, _ = get(port, "/preset?path=image", timeout=5)
                break
            except OSError:
                need(time.perf_counter() - t0 < SERVER_START_S, f"no answer within {SERVER_START_S} s")
                time.sleep(0.1)
        timing["first_answer_s"] = time.perf_counter() - t0
        out["first_answer_status"] = status

        status, body, t = post(port, "/systemInfo", {"session": "sys"})
        need(status == 200 and isinstance(body["result"], list) and len(body["result"]) == torch.cuda.device_count()
             and all(m > 0 for m in body["result"]), f"/systemInfo {status} {body}")
        out["system_info_free_mib"], timing["system_info_s"] = body["result"], t["wall"]

        png = open(mainIn, "rb").read()
        for i, name in enumerate(("image_first", "image_warm")):
            with MsgPoller(port, name, "/image_enhance") as poller:
                tReq = time.perf_counter()
                status, body, t = post(port, "/image_enhance", {"session": name, "steps": json.dumps(STEPS)},
                                       [("file", "in.png", png)])
            need(status == 200, f"/image_enhance {status} {body}")
            got = readPng(os.path.join(cwd, body["result"]))
            lsb = lsbApart(got, mainOut)
            need(lsb <= 1, f"{name}: {body['result']} {got.shape} is {lsb} LSB from the main phase's output")
            progress = [(at, n) for at, n in poller.notes if "eta" in n and "total" in n]
            if i == 0:
                need(progress, f"/msg gave no progress note with eta during the first request: {poller.notes}")
            out[name] = {"file": body["result"], "lsb_from_main": lsb, "progress_notes": len(progress),
                         "notes": len(poller.notes)}
            # the worker's first progress note comes when its chain is built (models loaded) and starts
            timing[name] = dict(t, to_first_progress_note=progress[0][0] - tReq if progress else None)
        imageOut = got

        smalls = [np.random.RandomState(90 + i).randint(0, 256, (BATCH_H, BATCH_W, 3), dtype=np.uint8)
                  for i in range(2)]
        status, body, t = post(port, "/batch_enhance", {"session": "batch", "steps": json.dumps(STEPS)},
                               [("file", f"b{i}.png", pngOf(a)) for i, a in enumerate(smalls)])
        need(status == 200, f"/batch_enhance {status} {body}")
        result, count, done, fail = body["result"][:4]
        need((result, count, len(done), fail) == ("Success", 2, 2, 0), f"/batch_enhance {body}")
        for name in done:
            need(readPng(os.path.join(cwd, name)).shape == (UPSCALE * BATCH_H, UPSCALE * BATCH_W, 3), name)
        out["batch"], timing["batch"] = {"done": count, "failed": fail}, t

        status, body, t = post(port, "/video_enhance", {"session": "video", "steps": json.dumps(VIDEO_STEPS)},
                               [("file", "in.mkv", b"fake container")])
        need(status == 200, f"/video_enhance {status} {body}")
        path, frames = body["result"]
        with open(os.path.join(cwd, path)) as fp:
            meta = json.load(fp)
        need(frames == VIDEO_FRAMES and meta == {"bytes": (2 * VIDEO_FRAMES - 1) * W * H * 6, "s": f"{W}x{H}"},
             f"/video_enhance read {frames} frames, the encoder got {meta}")
        videoOut = rawFrames(os.path.join(cwd, path) + ".raw", 2 * VIDEO_FRAMES - 1)
        out["video"] = {"frames_in": frames, "frames_out": len(videoOut),
                        "lsb_from_video_phase": holdFrames("/video_enhance", videoOut, videoFrames)}
        timing["video"] = t

        import threading

        lock = {}
        locker = threading.Thread(target=lambda: lock.update(zip(
            ("status", "body", "t"), post(port, "/lockInterface", {"session": "lock",
                                                                   "steps": json.dumps([{"duration": 30}])}))))
        locker.start()
        while True:
            status, _, _ = post(port, "/stop", {"session": "lock"})
            if status == 200:
                break
            need(locker.is_alive() and time.perf_counter() - t0 < 1200, f"/stop never found the lock: {status}")
            time.sleep(0.1)
        tStop = time.perf_counter()
        locker.join(STOP_REPLY_S)
        stopS = time.perf_counter() - tStop
        need(not locker.is_alive() and lock["status"] == 200 and lock["body"]["result"] == "Interrupted"
             and lock["body"]["remain"] > 0 and stopS <= STOP_REPLY_S, f"lockInterface after /stop: {lock}")
        out["stop"] = {"reply": lock["body"], "seconds_after_stop": stopS}

        status, body, t = post(port, "/image_enhance", {"session": "bad", "steps": json.dumps(STEPS)},
                               [("file", "bad.png", b"not a png")])
        need(status == 400 and body["result"] == "Fail", f"malformed /image_enhance: {status} {body}")
        status2, body2, _ = post(port, "/image_enhance", {"session": "after", "steps": json.dumps(STEPS)},
                                 [("file", "after.png", pngOf(smalls[0]))])
        need(status2 == 200, f"the request after a failed one: {status2} {body2}")
        out["malformed"] = {"status": status, "result": body["result"], "next_status": status2}

        children = descendants(app.pid)
        need(children, "the app has no worker process")
        need(os.path.exists("/dev/shm/" + app_torch.shmName(app.pid)), "no shared-memory block named after the app")
        withApp = cudaContexts()  # nvidia-smi may see other pid numbers: count them
        need(withApp == contextsBefore + 1, f"{withApp} CUDA contexts with the app running, {contextsBefore} before "
             "it started: want one more, the worker's (the HTTP process must hold none)")
        out["cuda_contexts"] = {"before_app": contextsBefore, "with_app": withApp}
        app.send_signal(signal.SIGINT)
        app.wait(30)
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()
        log.close()
        deadline = time.perf_counter() + 30
        while any(procStat(p) and procStat(p)[0] != "Z" for p in children) and time.perf_counter() < deadline:
            time.sleep(0.2)
        left = [p for p in children if procStat(p) and procStat(p)[0] != "Z"]
        for p in left:
            os.kill(p, signal.SIGKILL)
        try:
            SharedMemory(app_torch.shmName(app.pid)).unlink()
            blockLeft = True
        except FileNotFoundError:
            blockLeft = False
    if left or blockLeft or app.returncode != 0:
        raise AssertionError(f"server: after SIGINT the app exited {app.returncode}, left processes {left}, "
                             f"left its shared-memory block: {blockLeft}\napp log:\n{appLog()}")
    out["shutdown"] = {"exit": app.returncode, "processes_left": 0, "shared_memory_left": False,
                       "children_seen": len(children)}
    return out, timing, imageOut, videoOut


class Stamps:
    """Wall-clock stamps of the in-process app's spans, by name (each call of
    a wrapped function adds a (start, end) pair)."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, f):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                self.spans.setdefault(name, []).append((t0, time.perf_counter()))

        return timed

    def last(self, name):
        return self.spans[name][-1]

    def total(self, name, since):
        return sum(b - a for a, b in self.spans.get(name, []) if a >= since)


class TimedPipe:
    def __init__(self, pipe, stamps, name):
        self.pipe, self.stamps, self.name = pipe, stamps, name

    def send(self, obj):
        self.stamps.spans.setdefault(self.name, []).append((time.perf_counter(),) * 2)
        return self.pipe.send(obj)

    def __getattr__(self, k):
        return getattr(self.pipe, k)


def runServerInProcess(work, appImage, appVideo):
    """The same server and ``worker()`` loop in this process: the server's
    WSGI app on a socket in one thread, the worker in another, over real
    pipes, a real stop event and a real shared-memory block.  One
    /image_enhance and one /video_enhance, their K1 and K2 launches
    counted (4 and 64), their outputs within 1 LSB of the app's; the
    request time split into upload (until the task is on the pipe),
    worker (the route; its PNG decode and encode apart) and reply."""
    import multiprocessing as mp
    import threading
    from multiprocessing.shared_memory import SharedMemory

    from werkzeug.serving import make_server

    import app_torch
    from moephoto_tpu_torch.config import defaultConfig
    from moephoto_tpu_torch.runtime.worker import worker
    from moephoto_tpu_torch.utils import imageio

    cwd, before = os.path.join(work, "inproc"), os.getcwd()
    os.makedirs(cwd)
    os.chdir(cwd)  # the server keeps its paths relative to the working directory, as in the app
    os.environ["FAKEFF_SIZE"], os.environ["FAKEFF_FRAMES"] = f"{W}x{H}", str(VIDEO_FRAMES)
    shm = SharedMemory(create=True, size=defaultConfig["sharedMemSize"][0])
    taskRx, taskTx = mp.Pipe(False)
    resultRx, resultTx = mp.Pipe(False)
    noteRx, noteTx = mp.Pipe(False)
    stop = mp.Event()
    stamps = Stamps()
    routes = {k: stamps.wrap(k, f) for k, f in app_torch.routes().items()}
    saved = imageio.readFile, imageio.writeFile
    imageio.readFile, imageio.writeFile = stamps.wrap("decode", imageio.readFile), stamps.wrap("encode", imageio.writeFile)

    def serve():
        try:
            worker(lambda: (shm, routes), taskRx, resultTx, noteTx, stop, False)
        except EOFError:  # the task pipe closed: the phase is over
            pass

    loop = threading.Thread(target=serve, daemon=True)
    loop.start()
    import moephoto_tpu_torch.runtime.server as S

    S.runserver(taskTx, resultRx, noteRx, stop, shm, False)
    S.sender = TimedPipe(S.sender, stamps, "task_sent")
    port = freePort()
    httpd = make_server("127.0.0.1", port, S.app, threaded=True)
    web = threading.Thread(target=httpd.serve_forever, daemon=True)
    web.start()
    out, timing = {}, {}
    try:
        png = open(os.path.join(work, "in.png"), "rb").read()

        def split(tReq, tEnd, route):
            r0, r1 = stamps.last(route)
            return {"wall": tEnd - tReq, "upload": stamps.last("task_sent")[0] - tReq, "worker": r1 - r0,
                    "decode": stamps.total("decode", r0), "encode_and_write": stamps.total("encode", r0),
                    "reply": tEnd - r1}

        resetCounts()
        tReq = time.perf_counter()
        status, body, _ = post(port, "/image_enhance", {"session": "i1", "steps": json.dumps(STEPS)},
                               [("file", "in.png", png)])
        tEnd = time.perf_counter()
        counts = readCounts()
        if status != 200:
            raise AssertionError(f"in-process /image_enhance: {status} {body}")
        lsb = lsbApart(readPng(body["result"]), appImage)
        if counts["fusedUpHeads"] != 4 or lsb > 1:
            raise AssertionError(f"in-process /image_enhance: launches {counts}, {lsb} LSB from the app's")
        out["image"] = {"launches": counts, "lsb_from_app": lsb}
        timing["image"] = split(tReq, tEnd, "image_enhance")
        with FrameCapture() as cap:
            resetCounts()
            tReq = time.perf_counter()
            status, body, _ = post(port, "/video_enhance", {"session": "v1", "steps": json.dumps(VIDEO_STEPS)},
                                   [("file", "in.mkv", b"fake container")])
            tEnd = time.perf_counter()
            counts = readCounts()
        if status != 200 or counts["warp"] != 8 * (VIDEO_FRAMES - 1):
            raise AssertionError(f"in-process /video_enhance: {status} {body}, launches {counts}")
        frames = [np.frombuffer(b, np.uint16) for b in cap.frames]
        out["video"] = {"launches": counts, "frames_out": len(frames),
                        "lsb_from_app": holdFrames("in-process /video_enhance", frames, appVideo)}
        timing["video"] = split(tReq, tEnd, "video_enhance")
    finally:
        httpd.shutdown()
        web.join(30)
        taskTx.close()
        loop.join(30)
        imageio.readFile, imageio.writeFile = saved
        from moephoto_tpu_torch.runtime.context import context

        context.shared = context.sharedView = None  # drop the views before the block closes
        shm.close()
        shm.unlink()
        os.chdir(before)
    if loop.is_alive() or web.is_alive():
        raise AssertionError("the in-process worker or server thread did not stop")
    return out, timing


def runServer(work, smi, videoFrames):
    """The ``server`` phase: the app in its own processes, then the same
    server and worker loop in this one."""
    torch.cuda.empty_cache()  # the app's worker is another process on this card
    mainOut = readPng(os.path.join(work, "out.png"))
    app, appTiming, appImage, appVideo = runServerApp(work, os.path.join(work, "in.png"), mainOut, videoFrames)
    inproc, inprocTiming = runServerInProcess(work, appImage, appVideo)
    emit(phase="server", gpu=smi, steps=STEPS, video_steps=VIDEO_STEPS, app=app, in_process=inproc)
    emit(phase="server_timing", gpu=smi, app_client_seconds=appTiming, in_process_seconds=inprocTiming)
    return inproc["image"]["launches"]["fusedUpHeads"], inproc["video"]["launches"]["warp"]


# --- training (moephoto_tpu_torch/parallel/sharded.py train steps, tools/train.py, tools/dryrun.py) ---------------

TRAIN_BATCH, TRAIN_PATCH, TRAIN_SCALE, TRAIN_HALO = 8, 64, 2, 8  # tools/train.py's defaults; lite's halo
TRAIN_IMAGES, TRAIN_SIZE = 4, 512  # synthetic structured images of tests/test_train.py, larger
TRAIN_LR, TRAIN_STEPS, TRAIN_RESUMED = 2e-3, 200, 40  # the CLI run: from scratch, bf16, then resumed
TRAIN_GAIN_DB = 3.0  # the held-out PSNR gain of tests/test_train.py's quality gate
# one fp32 SGD step on the card (TF32 off) against the CPU: the loss is a mean
# over 131072 pixels and each gradient a sum over up to as many terms, which
# cuDNN and the CPU add in other orders (and cuDNN's backward not bit-stably)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-3  # the gradient relative to its largest |entry|, per parameter
TRAIN_WARM, TRAIN_TIMED = 5, 30
TRAIN_LARGE = (32, 128)  # batch, patch: launches no longer dominate


def trainImages(work):
    """``TRAIN_IMAGES`` training images and one held-out image of
    ``TRAIN_SIZE`` px (tests/test_train.py's pattern: sines times cosines
    plus seeded noise; the held-out one at another phase, noise-free)."""
    from PIL import Image

    data, hold = os.path.join(work, "train"), os.path.join(work, "train_holdout")
    os.makedirs(data, exist_ok=True)
    os.makedirs(hold, exist_ok=True)
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:TRAIN_SIZE, 0:TRAIN_SIZE].astype(np.float32) / TRAIN_SIZE
    for i in range(TRAIN_IMAGES):
        im = 0.5 + 0.3 * np.sin(8 * yy + i) * np.cos(6 * xx) + 0.1 * rng.rand(TRAIN_SIZE, TRAIN_SIZE)
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(os.path.join(data, f"im{i}.png"))
    im = 0.5 + 0.3 * np.sin(8 * yy + 0.7) * np.cos(6 * xx + 0.3)
    Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(os.path.join(hold, "h.png"))
    return os.path.join(data, "*.png"), os.path.join(hold, "*.png")


def trainBatch(dataGlob, seed, batch=TRAIN_BATCH, patch=TRAIN_PATCH):
    """One (LR, HR) batch of the CLI's sampler, numpy fp32."""
    import glob

    from moephoto_tpu_torch.tools.train import PatchSampler

    return PatchSampler(sorted(glob.glob(dataGlob)), patch, TRAIN_SCALE, seed).batch(batch)


def sgdGradient(devices, shape, sd, x, y):
    """The loss and gradient of one fp32 ``makeShardedTrainStep`` of lite
    x2 on a mesh of ``devices``: the step at lr 1, its update read back as
    the gradient (fp64 on the CPU)."""
    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.parallel.mesh import makeMesh
    from moephoto_tpu_torch.parallel.sharded import makeShardedTrainStep

    step = makeShardedTrainStep(MoeNetLite2(TRAIN_SCALE, fused=False), makeMesh(shape, devices=devices), TRAIN_HALO,
                                TRAIN_SCALE, lr=1.0)
    new, loss = step(sd, torch.from_numpy(x), torch.from_numpy(y))
    return float(loss), {k: sd[k].double() - v.cpu().double() for k, v in new.items()}


def checkTrainSteps(seed, dataGlob):
    """Checks 1 and 2: one fp32 SGD step on the card against the CPU, on
    [1, 1] and on cuda:0 x [2, 2] against cpu x [2, 2] (each mesh against
    its own shape: FRM's pool is taken per padded shard)."""
    from moephoto_tpu_torch.synth import synthLite2Params

    sd = synthLite2Params(TRAIN_SCALE, seed)
    x, y = trainBatch(dataGlob, seed)
    out = {}
    for shape in ([1, 1], [2, 2]):
        n = shape[0] * shape[1]
        cardLoss, cardGrad = sgdGradient(["cuda:0"] * n, shape, sd, x, y)
        cpuLoss, cpuGrad = sgdGradient(["cpu"] * n, shape, sd, x, y)
        lossErr = abs(cardLoss - cpuLoss) / cpuLoss
        gradErr = {k: float((cardGrad[k] - g).abs().max() / g.abs().max()) for k, g in cpuGrad.items()}
        worst = max(gradErr, key=gradErr.get)
        if not (lossErr <= TRAIN_LOSS_RTOL and gradErr[worst] <= TRAIN_GRAD_TOL and np.isfinite(cardLoss)):
            raise AssertionError(f"the card's SGD step on {shape} differs from the CPU's: loss {cardLoss} against "
                                 f"{cpuLoss}, gradient of {worst} {gradErr[worst]} of its largest entry")
        out[f"{shape[0]}x{shape[1]}"] = dict(loss_card=cardLoss, loss_cpu=cpuLoss, loss_rel_err=lossErr,
                                            grad_worst_rel_err=gradErr[worst], grad_worst_param=worst)
    return out


def trainCli(argv):
    """``tools/train.main(argv)`` with its printed lines captured."""
    import contextlib
    import io

    from moephoto_tpu_torch.tools import train

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        params = train.main(argv)
    return params, buf.getvalue().splitlines(), time.perf_counter() - t0


def runTrainCli(work, dataGlob, holdGlob):
    """Check 3: the fine-tuning CLI on the card, lite x2 from scratch in
    bf16 with the held-out PSNR, then resumed from its checkpoint."""
    out = os.path.join(work, "train_out")
    argv = ["--data", dataGlob, "--model", "lite", "--scale", str(TRAIN_SCALE), "--lr", str(TRAIN_LR),
            "--out", out, "--fromScratch", "--computeDtype", "bf16", "--holdout", holdGlob, "--saveEvery", "1000"]
    first, lines, seconds = trainCli(argv + ["--steps", str(TRAIN_STEPS)])
    psnr = {ln.split(":")[0][len("held-out PSNR "):]: float(ln.split(": ")[1].split(" dB")[0])
            for ln in lines if ln.startswith("held-out PSNR ")}
    if not psnr["after"] >= psnr["before"] + TRAIN_GAIN_DB:
        raise AssertionError(f"fine-tuning gained {psnr['after'] - psnr['before']} dB held-out, want {TRAIN_GAIN_DB}")
    if not os.path.isfile(os.path.join(out, "state", "train.pt")):
        raise AssertionError("the CLI wrote no checkpoint")
    total = TRAIN_STEPS + TRAIN_RESUMED
    second, resumedLines, resumedSeconds = trainCli(argv + ["--steps", str(total), "--resume"])
    if resumedLines[0] != f"resumed from step {TRAIN_STEPS}" or not resumedLines[2].startswith(
            f"step {TRAIN_STEPS + 1}/{total} loss "):
        raise AssertionError(f"resume did not continue: {resumedLines[:3]}")
    moved = max(float((second[k] - v).abs().max()) for k, v in first.items())
    if not moved > 0 or any(v.dtype != torch.float32 for v in second.values()):
        raise AssertionError(f"resuming moved the weights by {moved}, dtypes {set(v.dtype for v in second.values())}")
    return second, dict(steps=TRAIN_STEPS, resumed_to=total, psnr_db=psnr, seconds=seconds,
                        resumed_seconds=resumedSeconds, moved_by_resume=moved, lines=lines[:2] + lines[-3:],
                        resumed_lines=resumedLines[:3] + resumedLines[-2:])


def trainedInference(params, seed, dataGlob):
    """Check 4: the trained state dict in the inference MoeNetLite2 x2 on
    the card, a 1080p luma plane through the fused path (K1) and the plain
    up path, fp32 and bf16; the module's prepared K1 weights were built for
    the seeded weights first, so the fused output shows they were rebuilt."""
    import glob

    from PIL import Image

    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.synth import synthLite2Params

    with Image.open(sorted(glob.glob(dataGlob))[0]) as img:
        tile = np.asarray(img.convert("L"), np.float32) / 255.0
    plane = np.tile(tile, (-(-H // tile.shape[0]), -(-W // tile.shape[1])))[:H, :W]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(plane).to("cuda", dtype)[None, :, :, None]
        model = MoeNetLite2(TRAIN_SCALE).to("cuda", dtype).eval()
        model.load_state_dict(synthLite2Params(TRAIN_SCALE, seed), strict=True)
        with torch.inference_mode():
            before = model(x).float()
        model.load_state_dict(params, strict=True)  # an in-place write: K1's prepared weights go stale
        with torch.inference_mode():
            fused = model(x).float()
            model.fused = False
            plain = model(x).float()
        torch.cuda.synchronize()
        diff = (fused - plain).abs()
        if dtype == torch.float32:
            ok = bool((diff <= FP32_TOL).all())
        else:
            ok = bool((diff <= BF16_REL * plain.abs() + BF16_ABS).all())
        moved = float((fused - before).abs().max())
        name = str(dtype)[6:]
        if not (ok and torch.isfinite(fused).all() and fused.shape == (1, 2 * H, 2 * W, 1) and moved > 1e-3):
            raise AssertionError(f"trained weights through K1 ({name}): {float(diff.max())} from the plain path, "
                                 f"moved {moved} from the seeded weights' output")
        out[name] = dict(max_abs_err=float(diff.max()), moved_from_seeded=moved)
        del model, x, before, fused, plain, diff
    return out


def runTrain(seed, work, smi):
    """The ``train`` phase: checks 1 to 5 (see the module docstring)."""
    from moephoto_tpu_torch.tools.dryrun import cardsFor, describe, dryrunMultichip

    dataGlob, holdGlob = trainImages(work)
    t0 = time.perf_counter()
    steps = checkTrainSteps(seed, dataGlob)
    stepSeconds = time.perf_counter() - t0
    resetCounts()
    params, cli = runTrainCli(work, dataGlob, holdGlob)
    cliCounts = readCounts()
    if any(cliCounts.values()):
        raise AssertionError(f"training launched a hand-written kernel: {cliCounts}")
    inference = trainedInference(params, seed, dataGlob)
    counts = readCounts()
    launches = counts["fusedUpHeads"]
    if launches != 4:  # a fused call with the seeded and one with the trained weights, fp32 and bf16
        raise AssertionError(f"fusedUpHeads launched {launches} times on the trained weights, want 4")
    resetCounts()
    t0 = time.perf_counter()
    line = dryrunMultichip(8)  # the cards: cuda:0 x 8 on one
    dryrunSeconds = time.perf_counter() - t0
    dryrunCounts = readCounts()
    want = ("infer=(4, 192, 64, 1) video=(3, 256, 256, 3) estrnn=(2, 64, 64, 3) ifrnet=(2, 1, 64, 64, 3) "
            f"devices={describe(cardsFor(8))}")
    loss = float(line.split(" loss=")[1].split()[0])
    if not (line.endswith(want) and np.isfinite(loss)):
        raise AssertionError(f"dryrun line {line!r}, want {want}")
    emit(phase="train", gpu=smi, model="lite x2", batch=TRAIN_BATCH, patch=TRAIN_PATCH,
         loss_rtol=TRAIN_LOSS_RTOL, grad_tol=TRAIN_GRAD_TOL, sgd_card_vs_cpu=steps, sgd_seconds=stepSeconds,
         cli=cli, cli_launches=cliCounts, trained_inference=inference, trained_launches=counts,
         dryrun=line, dryrun_seconds=dryrunSeconds, dryrun_launches=dryrunCounts)
    return launches


def timingTrain(seed, smi, dataGlob):
    """The ``train_timing`` phase: Adam steps of lite x2 (makeOptaxTrainStep,
    the CLI's step) in fp32 and bf16 on [1, 1] and cuda:0 x [2, 2] at the
    CLI's defaults, and at TRAIN_LARGE on [1, 1]: the median step by CUDA
    events over TRAIN_TIMED steps after TRAIN_WARM, LR Mpx/s of patches,
    FLOP a step as torch's FlopCounterMode counts one step's convolutions
    and products (forward and backward), TFLOP/s, peak memory above what
    earlier phases left allocated (the setting's batch, masters, Adam's
    state and activations, FlopCounterMode's step included), and one
    profiled step's idle share and top kernels.  On one card [2, 2] measures
    what sharding costs, not scaling."""
    from torch.utils.flop_counter import FlopCounterMode

    from moephoto_tpu_torch.models.sr import MoeNetLite2
    from moephoto_tpu_torch.parallel.mesh import makeMesh
    from moephoto_tpu_torch.parallel.sharded import makeOptaxTrainStep
    from moephoto_tpu_torch.synth import synthLite2Params

    settings = [(d, s, TRAIN_BATCH, TRAIN_PATCH) for s in ([1, 1], [2, 2]) for d in (torch.float32, torch.bfloat16)]
    settings += [(d, [1, 1]) + TRAIN_LARGE for d in (torch.float32, torch.bfloat16)]
    report = {}
    for dtype, shape, batch, patch in settings:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()  # earlier phases' tensors: not this setting's
        torch.cuda.reset_peak_memory_stats()
        x, y = (torch.from_numpy(a).to("cuda") for a in trainBatch(dataGlob, seed, batch, patch))
        masters = {k: v.to("cuda").requires_grad_() for k, v in synthLite2Params(TRAIN_SCALE, seed).items()}
        opt = torch.optim.Adam(masters.values(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
        step = makeOptaxTrainStep(MoeNetLite2(TRAIN_SCALE, fused=False),
                                  makeMesh(shape, devices=["cuda:0"] * (shape[0] * shape[1])), opt, TRAIN_HALO,
                                  TRAIN_SCALE, computeDtype=None if dtype == torch.float32 else dtype)
        with FlopCounterMode(display=False) as counter:
            step(masters, x, y)
        flop = counter.get_total_flops()
        for _ in range(TRAIN_WARM):
            step(masters, x, y)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(TRAIN_TIMED)]
        for start, end in events:
            start.record()
            _, loss = step(masters, x, y)
            end.record()
        torch.cuda.synchronize()
        ms = sorted(s.elapsed_time(e) for s, e in events)
        median = ms[len(ms) // 2]
        peak = torch.cuda.max_memory_allocated() - resident  # batch, masters, Adam's state, activations
        wallMs, rows = profileOnce(lambda: step(masters, x, y))
        deviceMs = sum(t for _, t in rows)
        name = f"{str(dtype)[6:]}_{shape[0]}x{shape[1]}_b{batch}_p{patch}"
        report[name] = dict(ms_per_step=median, ms_min=ms[0], ms_max=ms[-1], lr_mpx_per_s=batch * patch * patch / median / 1e3,
                            gflop_per_step=flop / 1e9, tflops=flop / median / 1e9, peak_memory_mib=peak / 2**20,
                            resident_mib=resident / 2**20,
                            loss=float(loss), profiled_wall_ms=wallMs, profiled_device_ms=deviceMs,
                            device_idle_share=(1 - deviceMs / wallMs) if wallMs else None,
                            top_kernels=[{"name": k[:80], "ms": t} for k, t in rows[:6]])
        del x, y, masters, opt, step
        torch.cuda.empty_cache()
    emit(phase="train_timing", gpu=smi, optimizer="Adam", warmup=TRAIN_WARM, timed=TRAIN_TIMED,
         note="cuda:0 x [2, 2] is four shards on one card: the cost of sharding, not scaling", settings=report)
    return report


# --- the deploy phase: export, package, calibrate ------------------------------

# each exported model: the one op node its program must hold on the card, and the wrapper whose count it launches
EXPORT_NODES = {"lite4": ("moephoto_torch.fused_up_heads.default", "fusedUpHeads"),
                "AiLUT_sRGB_3": ("moephoto_torch.ailut_transform.default", "ailutTransform")}
CALIBRATE = ["lite4", "--tiles", "192,256,384", "--batches", "2,4,8", "--size", f"{H}x{W}"]
# the main path as PERF.md records it before the ops were registered (chip_smoke.py on an H100 SXM at 700 W):
# lite x4 1080p Mpx/s over runs, K1's and K4's ms a launch
EARLIER = {"lite_x4_mpx_per_s": [60.9, 65.0], "fusedUpHeads_ms": 1.285, "ailutTransform_ms": 0.0533}
OP_CALLS = 500  # launches a side when the registered op's host cost is timed
# run in a fresh process: argv root, program, input, output; prints the kernels' launch counts
LOAD_EXPORTED = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from moephoto_tpu_torch.ops import fusedup, lut
from moephoto_tpu_torch.tools.export import loadExported
program = loadExported(sys.argv[2])
y = program(torch.load(sys.argv[3]).cuda())
torch.cuda.synchronize()
torch.save(y.cpu(), sys.argv[4])
print(json.dumps({"fusedUpHeads": fusedup.fusedUpHeads.launches, "ailutTransform": lut.ailutTransform.launches,
                  "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}))
"""


def runExport(seed, work):
    """lite4 at the tile input shape its TileSpec gives the tiler for a 1080p
    image and AiLUT_sRGB_3 at 1080p, exported through tools/export.py on the
    card (bf16 and fp32, as the registry runs them): one op node each; each
    file loaded in a fresh process through loadExported (default TF32 flags
    there) on a seeded input, its output bit-equal to the eager module's on
    the same input, and the process's K1 and K4 launches above 0."""
    from moephoto_tpu_torch.engine.tiling import paddedExtent
    from moephoto_tpu_torch.pipeline import registry
    from moephoto_tpu_torch.tools import export

    spec = registry.SR_REGISTRY["lite4"]["spec"]
    tile = lambda n: spec.tile if n > spec.tile else paddedExtent(n, spec.tile, spec.pad, spec.align)  # noqa: E731
    shapes = {"lite4": (tile(H), tile(W)), "AiLUT_sRGB_3": (H, W)}
    report, procs, eager = {}, {}, {}
    try:
        for i, (name, (h, w)) in enumerate(shapes.items()):
            resetCounts()
            t0 = time.perf_counter()
            exported, path = export.exportModel(name, os.path.join(work, f"{name}.pt2"), h, w)
            seconds = time.perf_counter() - t0
            nodes = [str(n.target) for n in exported.graph.nodes
                     if n.op == "call_function" and str(n.target).startswith("moephoto_torch.")]
            if nodes != [EXPORT_NODES[name][0]]:
                raise AssertionError(f"{name}: the program holds {nodes}, want one {EXPORT_NODES[name][0]}")
            entry = export.lookup(name)
            g = torch.Generator().manual_seed(seed + 40 + i)
            x = torch.rand((1, h, w, 1 if entry["channelSplit"] else 3), generator=g)
            xPath, yPath = os.path.join(work, f"{name}_x.pt"), os.path.join(work, f"{name}_y.pt")
            torch.save(x, xPath)
            ex = registry.buildExec(entry)
            with torch.no_grad():
                eager[name] = export.Program(ex.model, ex.dtype)(x.cuda()).cpu()
            procs[name] = (subprocess.Popen([sys.executable, "-c", LOAD_EXPORTED, ROOT, path, xPath, yPath],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), yPath)
            report[name] = {"input": list(x.shape), "dtype": str(ex.dtype), "export_seconds": seconds,
                            "bytes": os.path.getsize(path), "op_nodes": nodes, "constants": len(exported.constants),
                            "eager_launches": readCounts()}  # the export's eager call, then the reference's
        t0 = time.perf_counter()
        for name, (proc, yPath) in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"loading the exported {name} failed:\n{err[-3000:]}")
            counts = json.loads(out.strip().splitlines()[-1])
            got, want = torch.load(yPath), eager[name]
            if got.shape != want.shape or not torch.equal(got, want) or not counts[EXPORT_NODES[name][1]] > 0:
                diff = float((got - want).abs().max()) if got.shape == want.shape else None
                raise AssertionError(f"{name}: loaded program {tuple(got.shape)}, max |diff| {diff} from eager, "
                                     f"launches {counts}")
            report[name].update(loaded_launches=counts, bit_equal=True, output_mean=float(got.mean()))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit(phase="export", load_seconds=time.perf_counter() - t0, models=report)
    return {wrapper: report[name]["loaded_launches"][wrapper] for name, (_, wrapper) in EXPORT_NODES.items()}


def runPackage(work):
    """tools/package.py --models lite4 into the work directory, then the
    tree's ``python -m moephoto_tpu_torch.cli image`` on the main phase's
    1080p PNG with lite x4 from the tree's root, nvcc off PATH and CUDA_HOME
    at a missing directory: its PNG 0 LSB from the main phase's, and no new
    file in the tree's build/."""
    import shutil

    from PIL import Image

    from moephoto_tpu_torch.tools import package

    tree = os.path.join(work, "tree")
    t0 = time.perf_counter()
    result = package.main(["--out", tree, "--models", "lite4"])
    packSeconds = time.perf_counter() - t0
    with open(os.path.join(tree, "manifest.json")) as fp:
        man = json.load(fp)
    build = os.path.join(tree, "build")
    before = sorted(os.listdir(build))
    sources = glob.glob(os.path.join(ROOT, "moephoto_tpu_torch", "csrc", "*.cu"))
    if before != sorted(os.path.basename(k["library"]) for k in man["kernels"]) or len(before) != len(sources):
        raise AssertionError(f"the tree's build/ holds {before}, the manifest {man['kernels']}")
    os.makedirs(os.path.join(tree, "model", "lite"))
    shutil.copy2(os.path.join(work, "lite", "model_4.pth"), os.path.join(tree, "model", "lite", "model_4.pth"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.pathsep.join(d for d in env.get("PATH", "").split(os.pathsep)
                                  if not os.path.exists(os.path.join(d, "nvcc")))
    env["CUDA_HOME"] = os.path.join(work, "no-cuda-toolkit")
    if shutil.which("nvcc", path=env["PATH"]):
        raise AssertionError("nvcc is still on PATH")
    dst = os.path.join(work, "tree_out.png")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "moephoto_tpu_torch.cli", "image", os.path.join(work, "in.png"), dst,
                           "--steps", json.dumps(STEPS)], cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    cliSeconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the tree's cli failed:\n{proc.stderr[-3000:]}")
    after = sorted(os.listdir(build))
    with Image.open(dst) as a, Image.open(os.path.join(work, "out.png")) as b:
        lsb = lsbApart(np.asarray(a), np.asarray(b))
    if lsb != 0 or after != before:
        raise AssertionError(f"the tree's output is {lsb} LSB from the main phase's; build/ {before} -> {after}")
    emit(phase="package", result=result, manifest=man, package_seconds=packSeconds, cli_seconds=cliSeconds,
         lsb_from_main=lsb, build_files=after, nvcc_on_path=False, cuda_home=env["CUDA_HOME"])


def runCalibrate(smi):
    """tools/calibrate.py on lite4 at 1080p over tiles 192, 256, 384 x
    batches 2, 4, 8: nine points and a best (its own lines, then this)."""
    from moephoto_tpu_torch.tools import calibrate

    t0 = time.perf_counter()
    results = calibrate.main(CALIBRATE)
    if len(results) != 9:
        raise AssertionError(f"calibration measured {len(results)} points, want 9")
    best = max(results, key=lambda r: r["mpx_per_s"])
    emit(phase="calibrate", gpu=smi, argv=CALIBRATE, seconds=time.perf_counter() - t0, points=results, best=best)


def hostUs(fn, n=OP_CALLS):
    """Microseconds of wall time a call over ``n`` calls of ``fn`` on work
    too small to keep the card busy: what the host spends on a launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def opCost(seed):
    """The host time the registered ops add to a launch: K1 (64 rows, the
    wgmma instance) and K4 (8x8 px) through the op against the same launch
    function called directly, in turns op, direct, direct, op."""
    from moephoto_tpu_torch.ops import fusedup, lut

    params, res, im, nUps = upCase(UPSCALE, 1, 64, torch.bfloat16, seed)
    up = fusedup.prepare(params, nUps, torch.bfloat16, "cuda")
    img, table, vertices = lutCase(seed, 1, 8, 8, 0.0, 1.0)
    args = {"fusedUpHeads": (res, im, list(up.tensors), nUps, up.cout, up.instance, up.slope01),
            "ailutTransform": (img, table, vertices)}
    calls = {"fusedUpHeads": (lambda: torch.ops.moephoto_torch.fused_up_heads(*args["fusedUpHeads"]),
                              lambda: fusedup._launch(*args["fusedUpHeads"])),
             "ailutTransform": (lambda: torch.ops.moephoto_torch.ailut_transform(*args["ailutTransform"]),
                                lambda: lut._launch(lut.ailutTransform, *args["ailutTransform"]))}
    report = {}
    for name, (op, direct) in calls.items():
        a, b, c, d = hostUs(op), hostUs(direct), hostUs(direct), hostUs(op)
        report[name] = {"op_us": [a, d], "direct_us": [b, c], "op_cost_us": (a + d - b - c) / 2}
    return report


def runDeploy(seed, work, smi, kt, lt):
    """The ``deploy`` phase: export, package, calibrate; then the main
    path's figures of this run beside PERF.md's, and the host time the
    registered ops add to a launch."""
    launches = runExport(seed, work)
    runPackage(work)
    runCalibrate(smi)
    now = {"lite_x4_mpx_per_s": kt["mpx_per_s"], "fusedUpHeads_ms": kt["ms"], "ailutTransform_ms": lt["ms"]}
    emit(phase="deploy_main", gpu=smi, this_run=now, perf_md=EARLIER, op_host_cost=opCost(seed), calls=OP_CALLS,
         note="K1 and K4 launch through their registered ops in this run; PERF.md's figures are from runs before")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.models.estrnn import modelPaths as estrnnPaths
    from moephoto_tpu_torch.models.iconvsr import modelPath_ as vsrPath
    from moephoto_tpu_torch.ops import _build, blend, deform, fusedup, layernorm, lut, warp
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
    sources = (fusedup.SOURCE, lut.SOURCE, warp.SOURCE, deform.SOURCE, blend.SOURCE, layernorm.SOURCE)
    _build.loadAll(sources)
    emit(phase="build", seconds=time.perf_counter() - t0, libraries={src: {
        "nvcc_seconds": _build.buildInfo[src]["seconds"],
        "library": os.path.relpath(_build.libraryPath(src), ROOT),
        "ptxas": [ln.strip() for ln in _build.buildInfo[src]["log"].splitlines()
                  if "registers" in ln or "spill" in ln]} for src in sources})

    phaseSeconds, since = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def mark(name):  # the seconds since the last mark, under ``name``
        now = time.perf_counter()
        phaseSeconds[name], since[0] = now - since[0], now

    errs = checkKernel(args.seed)
    lutErr = checkLut(args.seed)
    warpErr = checkWarp(args.seed)
    dcnErr = checkDcn(args.seed)
    clampErr = checkLutClamped(args.seed)
    clampLaunches, clampGateErr = runParity()
    bt = checkBlend(args.seed, smi)
    lnt = checkLayerNorm(args.seed, smi)
    mark("kernels+parity")

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
                              ("a2", "model_new.pth", synthMyNetParams(2, args.seed)),
                              ("ESTRNN", os.path.basename(estrnnPaths["1ms8ms"]), smokeESTRNNParams(args.seed))):
            os.makedirs(os.path.join(work, sub), exist_ok=True)
            torch.save(sd, os.path.join(work, sub, name))
        config.modelDir, config.opsPath, config.ffmpegPath = work, os.path.join(work, "ops.json"), fakeFfmpeg(work)
        mainCounts = runMainPath(args.seed, work)
        launches = mainCounts["fusedUpHeads"]
        checkCrop(args.seed)
        mark("main")
        lutLaunches, lutInput, lutModel = runRetouch(args.seed, work)
        checkRetouchCrop(args.seed)
        checkGenerate(args.seed)
        mark("retouch")
        kt = timing(args.seed, smi)
        timingRetouch(args.seed, smi)
        lt = timingLut(args.seed, smi, lutInput, lutModel)
        mark("timing")
        warpLaunches, pathInputs, slomoFrames = runVideo(work)
        checkVideoCrop(args.seed)
        wt = timingSlomo(args.seed, smi, pathInputs)
        checkOutputPath(args.seed, smi)
        checkInputPath(args.seed, smi)
        mark("video")
        dcnLaunches, dcnInputs, vsrFrames, edvrCalls, vsrWarps = runVsr(work)
        checkVsrCrop(args.seed)
        dt = timingVsr(args.seed, smi, dcnInputs)
        mark("vsr")
        demobFrames = runDemob(work)
        checkDemobCrop(args.seed)
        timingDemob(args.seed, smi)
        mark("demob")
        runImageChain("dn_chain", DN_CHAIN, (W, H), (W * UPSCALE, H * UPSCALE), args.seed + 9, work,
                      liteLaunches(W, H, UPSCALE))
        runImageChain("preset", PRESET, (PRESET_W, PRESET_H), (2 * PRESET_W, 2 * PRESET_H), args.seed + 10, work,
                      liteLaunches(PRESET_W, PRESET_H, 2))
        checkDnCrop(args.seed)
        ct = timingDn(args.seed, smi)
        mark("dn")
        zoo = [(name, step, draw) for name, (step, draw, _, _) in zooModels().items()]
        draws = {name: writeDraw(work, step, draw, args.seed + 30 + i) for i, (name, step, draw) in enumerate(zoo)
                 if name in ("MPRNet_denoising", "NAFNet_32")}
        k8Traced = runConfig3(args.seed + 11, work, draws)
        del draws
        runZoo(args.seed, work)
        timingZoo(args.seed, smi)
        mark("zoo")

        from PIL import Image

        meshErr = checkMeshKernels(args.seed, pathInputs, vsrWarps, dcnInputs, lutInput, lutModel)
        with Image.open(os.path.join(work, "out.png")) as out:
            runMeshImage(work, 2, np.asarray(out))
        k2aLaunches = {n: runMeshVideo(work, n, slomoFrames) for n in MESH_SIZES}
        videoFrames, slomoFrames = slomoFrames, runSingleVideo(work, UHD, UHD_FRAMES)
        for n in MESH_SIZES:
            runMeshVideo(work, n, slomoFrames, UHD, UHD_FRAMES)
        del slomoFrames
        checkMeshVideoCrop(args.seed)
        tierLaunches = {n: runMeshVsr(work, n, vsrFrames, edvrCalls) for n in MESH_SIZES}
        for n in MESH_SIZES:
            runMeshDemob(work, n, demobFrames)
        del vsrFrames, demobFrames
        checkMeshModelCrops(args.seed)
        k6Launches = driveUnpathed(lutInput, lutModel)
        mk = timingMesh(args.seed, smi, pathInputs, vsrWarps, dcnInputs, lutInput, lutModel)
        timingMeshModels(args.seed, smi)
        mark("mesh")
        serverLaunches = runServer(work, smi, videoFrames)
        del videoFrames
        mark("server")
        trainLaunches = runTrain(args.seed, work, smi)
        mark("train")
        timingTrain(args.seed, smi, os.path.join(work, "train", "*.png"))
        mark("train_timing")
        exportLaunches = runDeploy(args.seed, work, smi, kt, lt)
        mark("deploy")
    emit(phase="phase_seconds", seconds=phaseSeconds, total=time.perf_counter() - t0)

    print(json.dumps({"kernels": [{
        "name": "fusedUpHeads", "route": "cuda", "source": "moephoto_tpu_torch/csrc/fusedup.cu",
        "replaces": "moephoto_tpu/ops/fusedup.py:93", "launches": launches, "launches_server": serverLaunches[0],
        "launches_train": trainLaunches, "launches_export": exportLaunches["fusedUpHeads"],
        "max_abs_err": errs["nUps2_c48_M1966080_bfloat16"], "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"], "library_ms": None, "variant": kt["variant"],
    }, {
        "name": "ailutTransform", "route": "cuda", "source": "moephoto_tpu_torch/csrc/ailut.cu",
        "replaces": "moephoto_tpu/ops/lutkernel.py:185", "launches": lutLaunches,
        "launches_export": exportLaunches["ailutTransform"],
        "max_abs_err": lutErr, "ms": lt["ms"], "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"], "library_ms": None, "cold_ms": lt["cold_ms"],
    }, {
        "name": "warp", "route": "cuda", "source": "moephoto_tpu_torch/csrc/warp.cu",
        "replaces": "moephoto_tpu/ops/warp.py:170", "launches": warpLaunches, "launches_server": serverLaunches[1],
        "max_abs_err": warpErr, "ms": wt["ms"], "plain_ms": wt["plain_ms"],
        "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"], "library_ms": wt["library_ms"],
    }, {
        "name": "deformConv2d", "route": "cuda", "source": "moephoto_tpu_torch/csrc/dcn.cu",
        "replaces": "moephoto_tpu/ops/dcnkernel.py:184", "launches": dcnLaunches,
        "max_abs_err": dcnErr, "ms": dt["ms"], "plain_ms": dt["plain_ms"],
        "bound_ms": dt["bound_ms"], "bound_by": dt["bound_by"], "library_ms": None, "variant": dt["variant"],
    }, {  # replaces no TPU kernel: the JAX engine's overlap-add is a lax.scan; timed on the 1080p x4 plan
        "name": "blendTiles", "route": "cuda", "source": "moephoto_tpu_torch/csrc/blend.cu",
        "replaces": None, "launches": mainCounts["blendTiles"], "launches_check": bt["launches"],
        "max_abs_err": bt["max_abs_err"], "ms": bt["ms"],
        "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"], "library_ms": None,
    }, {  # replaces no TPU kernel: JAX's layerNorm2d is jnp; launches in a traced 1080p image through the CLI's
        # NAFNet_32 exec; ms after an L2 flush at the NAFNet cell's level 0, mode (a) (mode (b) in the _b fields)
        "name": "nhwcLayerNorm", "route": "cuda", "source": "moephoto_tpu_torch/csrc/layernorm.cu",
        "replaces": None, "launches": k8Traced, "max_abs_err": lnt["max_abs_err"], "ms": lnt["ms"],
        "plain_ms": lnt["plain_ms"], "bound_ms": lnt["bound_ms"], "bound_by": "bytes", "library_ms": lnt["library_ms"],
        "ms_b": lnt["ms_b"], "plain_ms_b": lnt["plain_ms_b"], "bound_ms_b": lnt["bound_ms_b"],
    }, {  # launched by the parity gate only; timed at the gate's shape, and at 1080p beside it
        "name": "ailutTransformClamped", "route": "cuda", "source": "moephoto_tpu_torch/csrc/ailut.cu",
        "replaces": "moephoto_tpu/ops/lutkernel.py:322", "launches": clampLaunches,
        "max_abs_err": max(clampErr, clampGateErr), "ms": ct["gate_32x64"]["ms"],
        "plain_ms": ct["gate_32x64"]["plain_ms"], "bound_ms": ct["gate_32x64"]["bound_ms"],
        "bound_by": ct["gate_32x64"]["bound_by"], "library_ms": None,
        "ms_1080p": ct["1080p"]["ms"], "plain_ms_1080p": ct["1080p"]["plain_ms"],
        "bound_ms_1080p": ct["1080p"]["bound_ms"], "cold_ms_1080p": ct["1080p"]["cold_ms"],
    }] + [{  # the row-sharded wrappers, on cuda:0 x 2: per-shard median launch at the named shape
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
        "max_abs_err": meshErr, "shards": 2, "shape": shape, **{k: mk[f"{name}_2_{shape}"][k] for k in
                                                                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "ms_4_shards": mk[f"{name}_4_{shape}"]["ms"], "bound_ms_4_shards": mk[f"{name}_4_{shape}"]["bound_ms"],
    } for name, source, replaces, n, shape in (
        ("warpSpmd", "moephoto_tpu_torch/csrc/warp.cu", "moephoto_tpu/ops/warp.py:264", k2aLaunches[2],
         "544x960x32_bfloat16"),
        ("deformConv2dSpmd", "moephoto_tpu_torch/csrc/dcn.cu", "moephoto_tpu/ops/deform.py:225", tierLaunches[2][0],
         "l1"),
        ("ailutTransformSpmd", "moephoto_tpu_torch/csrc/ailut.cu", "moephoto_tpu/ops/lutkernel.py:271", k6Launches,
         "1080p"))]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
