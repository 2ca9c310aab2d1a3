// Bilinear warp at exact pixel offsets (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel moephoto_tpu/ops/warp.py:170 _warpPallas (body
// _warpKernel :128), reached through warpBounded :322.  That kernel keeps
// an (8 + 2M, 96 + 2M) slab of the image per output block in VMEM and
// gathers along the 128-lane axis only, so it needs |flow| < M - 1 and
// three tiers (M = 8, M = 16, an XLA gather fallback).  The card gathers
// from any address, so this is the function itself with no tiers and no
// bound on the flow: out[b, y, x, c] = bilinear(img[b], x + u, y + v)[c],
// u = flow[b, y, x, 0], v = flow[b, y, x, 1], with
//   border  each tap's index clamped to the image;
//   zeros   a tap outside the image reads zero (gridSample, warp.py:67-69).
//
// Arithmetic, in the order of the plain version (ops/warp.py warpPlain),
// every fp32 operation an explicitly rounded intrinsic that nvcc never
// contracts into an FMA, so kernel and plain version agree bit for bit:
//   sx = x + u; wx = sx - floor(sx)         (the same for y)
//   top = v00 * (1 - wx) + v01 * wx; bot = v10 * (1 - wx) + v11 * wx
//   out = top * (1 - wy) + bot * wy, rounded once to the image's type.
// The tap indices come from the coordinate clamped to [-2, W + 1] (a NaN
// coordinate to -2), so a huge or non-finite flow never converts an
// out-of-range float to int and never reads out of bounds; the weights
// come from the unclamped coordinate, so a NaN flow gives NaN, and any
// finite result is unchanged (beyond the clamp both taps lie outside the
// image in either mode).
//
// Bound on this card: per output value one input value (the taps of
// neighbouring pixels overlap and hit L1/L2), one output value and a
// share of the flow, against ~10 fp32 operations, so bytes bound it
// (e.g. 544x960x32 bf16: 67 MB, 20 us at 3.35 TB/s).  One thread per
// (pixel, channel vector): when C is a multiple of the 16-byte vector
// (8 bf16, 4 fp32) and every pixel offset is aligned, each tap is one
// 16-byte __ldg and neighbouring threads read neighbouring addresses;
// otherwise (C = 3 image warps, ragged C) one thread per pixel loops over
// the channels with scalar __ldg.  Image and flow take any batch, row and
// pixel strides with unit channel stride, so a batch broadcast by
// expand() (stride 0) is read in place.  The output is contiguous NHWC.
//
// Row windows (K2a, the row-sharded form of moephoto_tpu/ops/warp.py:264
// warpBoundedSpmd and :227 backWarpBoundedSpmd): a launch may cover only
// the output rows [out0, out0 + H) of an image of `full` rows, with the
// image given as its rows [img0, img0 + imgN), a halo around the shard.
// The tap coordinate is formed from the GLOBAL row, (float)(out0 + y) + v,
// and the border clamp and the zeros test refer to the global image, so a
// shard computes the same fp32 values as the single-device launch, row for
// row; a tap row is then clamped into the window, which only a
// non-finite flow (NaN weight, NaN result) or a halo narrower than the
// flow's reach can reach.  The single-device launch is out0 = img0 = 0,
// imgN = full = H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 256;

__device__ __forceinline__ float loadF(const float* p) { return __ldg(p); }
__device__ __forceinline__ float loadF(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void storeF(float* p, float v) { *p = v; }
__device__ __forceinline__ void storeF(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ __forceinline__ static float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo(w[i]);
      f[2 * i + 1] = hi(w[i]);
    }
  }
  __device__ __forceinline__ static unsigned two(float a, float b) {
    const unsigned short ua = __bfloat16_as_ushort(__float2bfloat16(a));
    const unsigned short ub = __bfloat16_as_ushort(__float2bfloat16(b));
    return (unsigned)ua | ((unsigned)ub << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]), two(f[6], f[7]));
  }
};

struct Strides {
  long long b, h, w;  // elements; the channel stride is 1
};

// Rows of the launch in the global image (see the header).
struct Rows {
  int out0, img0, imgN, full;
};

// The four taps of one output pixel: element offsets of channel 0 in the
// image, whether each lies inside it (zeros mode), and the weights.
struct Taps {
  long long o00, o01, o10, o11;
  bool in00, in01, in10, in11;
  float wx, wy;
};

__device__ __forceinline__ float clampCoord(float s, int n) {
  return fminf(fmaxf(s, -2.0f), (float)(n + 1));  // fmaxf(NaN, -2) = -2
}

template <typename TF>
__device__ __forceinline__ Taps tapsAt(const TF* flow, Strides fs, Strides is, long long b, int y, int x,
                                       int W, Rows R, bool zeros) {
  const TF* f = flow + b * fs.b + y * fs.h + x * fs.w;
  const float sx = __fadd_rn((float)x, loadF(f));
  const float sy = __fadd_rn((float)(R.out0 + y), loadF(f + 1));
  Taps t;
  t.wx = __fsub_rn(sx, floorf(sx));
  t.wy = __fsub_rn(sy, floorf(sy));
  const int H = R.full;
  const int x0 = (int)floorf(clampCoord(sx, W)), y0 = (int)floorf(clampCoord(sy, H));
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool inX0 = x0 >= 0 && x0 < W, inX1 = x1 >= 0 && x1 < W;
  const bool inY0 = y0 >= 0 && y0 < H, inY1 = y1 >= 0 && y1 < H;
  t.in00 = !zeros || (inY0 && inX0);
  t.in01 = !zeros || (inY0 && inX1);
  t.in10 = !zeros || (inY1 && inX0);
  t.in11 = !zeros || (inY1 && inX1);
  const long long cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  // the global clamp, then into the window of image rows
  const long long cy0 = min(max(min(max(y0, 0), H - 1) - R.img0, 0), R.imgN - 1);
  const long long cy1 = min(max(min(max(y1, 0), H - 1) - R.img0, 0), R.imgN - 1);
  const long long base = b * is.b;
  t.o00 = base + cy0 * is.h + cx0 * is.w;
  t.o01 = base + cy0 * is.h + cx1 * is.w;
  t.o10 = base + cy1 * is.h + cx0 * is.w;
  t.o11 = base + cy1 * is.h + cx1 * is.w;
  return t;
}

__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, float wx, float wy) {
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
  const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
  return __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
}

// One thread per (pixel, 16-byte channel vector).
template <typename TI, typename TF>
__global__ void __launch_bounds__(kThreads)
warpVecKernel(const TI* __restrict__ img, Strides is, const TF* __restrict__ flow, Strides fs,
              TI* __restrict__ out, long long total, int H, int W, int C, Rows R, bool zeros) {
  constexpr int V = Vec<TI>::N;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int G = C / V;
  const int g = (int)(t % G);
  const long long p = t / G;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long b = p / ((long long)W * H);
  const Taps k = tapsAt(flow, fs, is, b, y, x, W, R, zeros);
  const int c = g * V;
  float a[V], v01[V], v10[V], v11[V];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  Vec<TI>::unpack(k.in00 ? __ldg(reinterpret_cast<const uint4*>(img + k.o00 + c)) : zero, a);
  Vec<TI>::unpack(k.in01 ? __ldg(reinterpret_cast<const uint4*>(img + k.o01 + c)) : zero, v01);
  Vec<TI>::unpack(k.in10 ? __ldg(reinterpret_cast<const uint4*>(img + k.o10 + c)) : zero, v10);
  Vec<TI>::unpack(k.in11 ? __ldg(reinterpret_cast<const uint4*>(img + k.o11 + c)) : zero, v11);
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = blend(a[i], v01[i], v10[i], v11[i], k.wx, k.wy);
  *reinterpret_cast<uint4*>(out + p * C + c) = Vec<TI>::pack(a);
}

// One thread per pixel, a loop over the channels (C = 3, ragged C).
template <typename TI, typename TF>
__global__ void __launch_bounds__(kThreads)
warpPixelKernel(const TI* __restrict__ img, Strides is, const TF* __restrict__ flow, Strides fs,
                TI* __restrict__ out, long long total, int H, int W, int C, Rows R, bool zeros) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long b = p / ((long long)W * H);
  const Taps k = tapsAt(flow, fs, is, b, y, x, W, R, zeros);
  for (int c = 0; c < C; ++c) {
    const float v00 = k.in00 ? loadF(img + k.o00 + c) : 0.0f;
    const float v01 = k.in01 ? loadF(img + k.o01 + c) : 0.0f;
    const float v10 = k.in10 ? loadF(img + k.o10 + c) : 0.0f;
    const float v11 = k.in11 ? loadF(img + k.o11 + c) : 0.0f;
    storeF(out + p * C + c, blend(v00, v01, v10, v11, k.wx, k.wy));
  }
}

template <typename TI, typename TF>
int launch(const void* img, Strides is, const void* flow, Strides fs, void* out, int B, int H, int W,
           int C, Rows R, int zeros, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || C > kMaxC) return cudaErrorInvalidValue;
  if (R.out0 < 0 || R.out0 + H > R.full || R.img0 < 0 || R.imgN < 1 || R.img0 + R.imgN > R.full)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  constexpr int V = Vec<TI>::N;
  const bool aligned = C % V == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 && is.b % V == 0 && is.h % V == 0 &&
                       is.w % V == 0;
  const long long pixels = (long long)B * H * W;
  const long long total = aligned ? pixels * (C / V) : pixels;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned) {
    warpVecKernel<TI, TF><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const TI*)img, is, (const TF*)flow, fs, (TI*)out, total, H, W, C, R, zeros != 0);
  } else {
    warpPixelKernel<TI, TF><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const TI*)img, is, (const TF*)flow, fs, (TI*)out, total, H, W, C, R, zeros != 0);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img: (B, imgN, W, C) of imgType (0 fp32, 1 bf16) with element strides
// (ib, ih, iw, 1), the rows [img0, img0 + imgN) of an image of `full` rows;
// flow: (B, H, W, 2) of flowType with strides (fb, fh, fw, 1), for the
// output rows [out0, out0 + H); out: contiguous (B, H, W, C) of imgType.
// zeros: 0 for border padding, 1 for zeros padding.  The single-device warp
// is out0 = img0 = 0, imgN = full = H.  Returns a cudaError_t.
int warpBilinear(int imgType, int flowType, const void* img, long long ib, long long ih, long long iw,
                 const void* flow, long long fb, long long fh, long long fw, void* out, int B, int H,
                 int W, int C, int out0, int img0, int imgN, int full, int zeros, void* stream) {
  const Strides is{ib, ih, iw}, fs{fb, fh, fw};
  const Rows R{out0, img0, imgN, full};
  if (imgType == 0 && flowType == 0)
    return launch<float, float>(img, is, flow, fs, out, B, H, W, C, R, zeros, stream);
  if (imgType == 0 && flowType == 1)
    return launch<float, __nv_bfloat16>(img, is, flow, fs, out, B, H, W, C, R, zeros, stream);
  if (imgType == 1 && flowType == 0)
    return launch<__nv_bfloat16, float>(img, is, flow, fs, out, B, H, W, C, R, zeros, stream);
  if (imgType == 1 && flowType == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(img, is, flow, fs, out, B, H, W, C, R, zeros, stream);
  return cudaErrorInvalidValue;
}

const char* warpErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
