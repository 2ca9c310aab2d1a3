// Modulated deformable 3x3 convolution, DCNv2 (K3), for Hopper (sm_90a).
//
// Replaces the TPU kernel moephoto_tpu/ops/dcnkernel.py:184 dcnDensePallas
// (body _dcnKernel :57), which ops/deform.py:166 deformConv2d dispatches
// to by tier.  That kernel folds bilinear sampling into hat weights over a
// [-M, M]^2 shift window of a VMEM slab, exact only while |offset| <= M,
// so JAX picks M = 1, M = 3 or an XLA gather from the call's largest
// |offset|.  The card gathers from any address, so this kernel computes
// the function itself for any offset, with no window and no tiers:
//   out[p, o] = bias[o] + sum_k sum_c W[k, c, o] * s[p, k, c]
//   s[p, k, c] = m[p, g, k] * bilinear(x[b, :, :, c], p + p_k + delta[p, g, k])
// with g = c / (C / dg), delta in (y, x) order, p_k = (ky * dil - pad,
// kx * dil - pad), and a corner outside the image reading zero
// (torchvision deform_conv2d; JAX _deformConvGather, deform.py:96).
//
// Rounding, as the Pallas body: s is formed in fp32 and rounded to x's
// type before the contraction (dcnkernel.py:153-155); the contraction
// accumulates in fp32; the bias is added in fp32 and the result rounded
// once to x's type (the Pallas path rounds before and after the bias,
// which differs by at most one bf16 ulp).  The sampling is written with
// explicitly rounded intrinsics in the order of the plain version
// (ops/deform.py deformConv2dPlain), so s agrees with it bit for bit:
//   sy = (y + ky dil - pad) + dy; wy = sy - floor(sy)   (the same for x)
//   top = v00 (1 - wx) + v01 wx; bot = v10 (1 - wx) + v11 wx
//   s = (top (1 - wy) + bot wy) * m
// Each coordinate is clamped to [-2, side + 1] (NaN to -2) before it
// becomes an index, so a huge or non-finite offset never converts an
// out-of-range float to int and never reads out of bounds (every corner
// then lies outside and reads zero, as in the gather path); the weights
// come from the unclamped coordinate, so a NaN offset gives NaN at its
// output pixel.
//
// Bound on this card: per output pixel the call must read C values of x,
// 2 dg 9 offsets and dg 9 mask values and write Cout values: 688 B at
// C = Cout = 64, dg = 8 in bf16, 0.35 ms for EDVR's full-resolution calls
// (7 x 384 x 640 pixels) at 3.35 TB/s, against 2 * 9 * C * Cout = 73.7
// kFLOP per pixel, 0.13 ms on the bf16 tensor cores: bytes bound it.  This
// first design runs the contraction on the fp32 CUDA cores (1.9 ms at 67
// TFLOP/s for the same call), so operations bound it in practice; moving
// the contraction to mma.sync/wgmma is later work.  What the design does:
// one block per 64 consecutive output pixels and a loop over the 9 taps.
// For each tap the threads sample the tile's C channels into shared memory
// (one thread per (pixel, group); each corner of a group's channels is one
// 16-byte __ldg when the group's channels allow it, so x is read in whole
// sectors) and stage the tap's (C, Cout) weight slice; then each thread
// accumulates a 4 pixel x 4 (or 8) output-channel tile in fp32 registers.
// Offsets and mask are read through their pixel strides with unit channel
// stride, so the offset part of conv_offset's output is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;  // output pixels per block: 16 rows of threads x 4 pixels
constexpr int kCoutChunk = 64;  // 16 columns of threads x 4 output channels
constexpr int kMaxC = 128, kMaxCout = 128;

struct Strides {
  long long b, h, w;  // elements; the channel stride is 1
};

__device__ __forceinline__ float toF(float v) { return v; }
__device__ __forceinline__ float toF(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float roundTo(float v, float) { return v; }
__device__ __forceinline__ float roundTo(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even, as torch's .to(bfloat16)
}
__device__ __forceinline__ void storeT(float* p, float v) { *p = v; }
__device__ __forceinline__ void storeT(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float loadAny(const void* p, long long i, bool bf16) {
  if (bf16)
    return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
  return __ldg(reinterpret_cast<const float*>(p) + i);
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
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float clampCoord(float s, int n) {
  return fminf(fmaxf(s, -2.0f), (float)(n + 1));  // fmaxf(NaN, -2) = -2
}

__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, float wx, float wy,
                                       float m) {
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
  const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
  return __fmul_rn(__fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy)), m);
}

struct Params {
  const void* x;
  Strides xs;
  const void* off;
  Strides os;
  const void* mask;
  Strides ms;
  bool offBf16, maskBf16;
  const void* taps;  // (9, C, Cout) of x's type
  const float* bias;  // (Cout,) or null
  void* out;  // contiguous (B, H, W, Cout) of x's type
  long long total;  // B * H * W
  int H, W, C, Cout, dg, pad, dil;
};

// Samples tap k of one (pixel, group) into its row of shared memory: cg
// channels starting at channel g * cg, each rounded to x's type.
template <typename T, bool VEC>
__device__ __forceinline__ void sampleGroup(const Params& P, int k, long long p, int g, float* row) {
  const int cg = P.C / P.dg;
  const int xq = (int)(p % P.W);
  const int yq = (int)((p / P.W) % P.H);
  const long long b = p / ((long long)P.W * P.H);
  const long long o = b * P.os.b + yq * P.os.h + xq * P.os.w + (long long)(g * 9 + k) * 2;
  const float dy = loadAny(P.off, o, P.offBf16), dx = loadAny(P.off, o + 1, P.offBf16);
  const float m = loadAny(P.mask, b * P.ms.b + yq * P.ms.h + xq * P.ms.w + g * 9 + k, P.maskBf16);
  const int ky = k / 3, kx = k % 3;
  const float sy = __fadd_rn((float)(yq + ky * P.dil - P.pad), dy);
  const float sx = __fadd_rn((float)(xq + kx * P.dil - P.pad), dx);
  const float wy = __fsub_rn(sy, floorf(sy)), wx = __fsub_rn(sx, floorf(sx));
  const int y0 = (int)floorf(clampCoord(sy, P.H)), x0 = (int)floorf(clampCoord(sx, P.W));
  const int y1 = y0 + 1, x1 = x0 + 1;
  const bool inY0 = y0 >= 0 && y0 < P.H, inY1 = y1 >= 0 && y1 < P.H;
  const bool inX0 = x0 >= 0 && x0 < P.W, inX1 = x1 >= 0 && x1 < P.W;
  const bool in00 = inY0 && inX0, in01 = inY0 && inX1, in10 = inY1 && inX0, in11 = inY1 && inX1;
  const T* x = reinterpret_cast<const T*>(P.x) + b * P.xs.b + (long long)g * cg;
  const long long o00 = y0 * P.xs.h + x0 * P.xs.w, o01 = y0 * P.xs.h + x1 * P.xs.w;
  const long long o10 = y1 * P.xs.h + x0 * P.xs.w, o11 = y1 * P.xs.h + x1 * P.xs.w;
  if constexpr (VEC) {
    constexpr int V = Vec<T>::N;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = 0; c < cg; c += V) {
      float v00[V], v01[V], v10[V], v11[V];
      Vec<T>::unpack(in00 ? __ldg(reinterpret_cast<const uint4*>(x + o00 + c)) : zero, v00);
      Vec<T>::unpack(in01 ? __ldg(reinterpret_cast<const uint4*>(x + o01 + c)) : zero, v01);
      Vec<T>::unpack(in10 ? __ldg(reinterpret_cast<const uint4*>(x + o10 + c)) : zero, v10);
      Vec<T>::unpack(in11 ? __ldg(reinterpret_cast<const uint4*>(x + o11 + c)) : zero, v11);
#pragma unroll
      for (int i = 0; i < V; ++i) row[c + i] = roundTo(blend(v00[i], v01[i], v10[i], v11[i], wx, wy, m), T());
    }
  } else {
    for (int c = 0; c < cg; ++c) {
      const float v00 = in00 ? toF(x[o00 + c]) : 0.0f;
      const float v01 = in01 ? toF(x[o01 + c]) : 0.0f;
      const float v10 = in10 ? toF(x[o10 + c]) : 0.0f;
      const float v11 = in11 ? toF(x[o11 + c]) : 0.0f;
      row[c] = roundTo(blend(v00, v01, v10, v11, wx, wy, m), T());
    }
  }
}

// One block per kTileP consecutive output pixels (flattened over B, H, W).
// Shared memory: samples [kTileP][C + 1] (the pad keeps the 4 pixels a
// thread reads in distinct banks) and the tap's weights [C][NCH * 64].
template <typename T, bool VEC, int NCH>
__global__ void __launch_bounds__(kThreads) dcnKernel(const Params P) {
  extern __shared__ float smem[];
  const int sStride = P.C + 1;
  const int CW = NCH * kCoutChunk;
  float* sS = smem;
  float* sW = smem + kTileP * sStride;  // kTileP * (C + 1) floats: a multiple of 4, so float4-aligned
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * kTileP;
  const T* taps = reinterpret_cast<const T*>(P.taps);
  float acc[4][4 * NCH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NCH; ++j) acc[i][j] = 0.0f;
  const int cg = P.C / P.dg;

  for (int k = 0; k < 9; ++k) {
    for (int i = tid; i < P.C * CW; i += kThreads) {
      const int c = i / CW, o = i % CW;
      sW[i] = o < P.Cout ? toF(taps[((long long)k * P.C + c) * P.Cout + o]) : 0.0f;
    }
    for (int it = tid; it < kTileP * P.dg; it += kThreads) {
      const int pl = it / P.dg, g = it % P.dg;
      float* row = sS + pl * sStride + g * cg;
      if (p0 + pl < P.total) {
        sampleGroup<T, VEC>(P, k, p0 + pl, g, row);
      } else {
        for (int c = 0; c < cg; ++c) row[c] = 0.0f;
      }
    }
    __syncthreads();
    const float* a0 = sS + (ty * 4) * sStride;
    for (int c = 0; c < P.C; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a0[i * sStride + c];
#pragma unroll
      for (int h = 0; h < NCH; ++h) {
        const float4 w = *reinterpret_cast<const float4*>(sW + c * CW + h * kCoutChunk + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][h * 4 + 0] = fmaf(a[i], w.x, acc[i][h * 4 + 0]);
          acc[i][h * 4 + 1] = fmaf(a[i], w.y, acc[i][h * 4 + 1]);
          acc[i][h * 4 + 2] = fmaf(a[i], w.z, acc[i][h * 4 + 2]);
          acc[i][h * 4 + 3] = fmaf(a[i], w.w, acc[i][h * 4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  T* out = reinterpret_cast<T*>(P.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty * 4 + i;
    if (p >= P.total) continue;
#pragma unroll
    for (int h = 0; h < NCH; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = h * kCoutChunk + tx * 4 + j;
        if (o < P.Cout)
          storeT(out + p * P.Cout + o, P.bias ? __fadd_rn(acc[i][h * 4 + j], P.bias[o]) : acc[i][h * 4 + j]);
      }
  }
}

template <typename T, bool VEC, int NCH>
int launchKernel(const Params& P, size_t smem, cudaStream_t s) {
  auto kernel = dcnKernel<T, VEC, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (P.total + kTileP - 1) / kTileP;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(P);
  return cudaGetLastError();
}

template <typename T>
int launch(const Params& P, cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  const int cg = P.C / P.dg;
  const bool vec = cg % V == 0 && reinterpret_cast<uintptr_t>(P.x) % 16 == 0 && P.xs.b % V == 0 &&
                   P.xs.h % V == 0 && P.xs.w % V == 0;
  const int nch = (P.Cout + kCoutChunk - 1) / kCoutChunk;
  const size_t smem = ((size_t)kTileP * (P.C + 1) + (size_t)P.C * nch * kCoutChunk) * sizeof(float);
  if (nch == 1)
    return vec ? launchKernel<T, true, 1>(P, smem, s) : launchKernel<T, false, 1>(P, smem, s);
  return vec ? launchKernel<T, true, 2>(P, smem, s) : launchKernel<T, false, 2>(P, smem, s);
}

}  // namespace

extern "C" {

// Types: 0 fp32, 1 bf16.  x (B, H, W, C) with element strides (xb, xh, xw,
// 1); offset (B, H, W, 2 dg 9) and mask (B, H, W, dg 9) likewise; taps
// (9, C, Cout) contiguous of x's type; bias (Cout,) fp32 or null; out
// contiguous (B, H, W, Cout) of x's type.  Returns a cudaError_t.
int dcnForward(int xType, int offType, int maskType, const void* x, long long xb, long long xh,
               long long xw, const void* off, long long ob, long long oh, long long ow, const void* mask,
               long long mb, long long mh, long long mw, const void* taps, const float* bias, void* out,
               int B, int H, int W, int C, int Cout, int dg, int pad, int dil, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || C > kMaxC || Cout < 1 || Cout > kMaxCout || dg < 1 || C % dg != 0 ||
      xType < 0 || xType > 1 || offType < 0 || offType > 1 || maskType < 0 || maskType > 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Params P;
  P.x = x;
  P.xs = Strides{xb, xh, xw};
  P.off = off;
  P.os = Strides{ob, oh, ow};
  P.mask = mask;
  P.ms = Strides{mb, mh, mw};
  P.offBf16 = offType == 1;
  P.maskBf16 = maskType == 1;
  P.taps = taps;
  P.bias = bias;
  P.out = out;
  P.total = (long long)B * H * W;
  P.H = H;
  P.W = W;
  P.C = C;
  P.Cout = Cout;
  P.dg = dg;
  P.pad = pad;
  P.dil = dil;
  cudaStream_t s = (cudaStream_t)stream;
  return xType == 0 ? launch<float>(P, s) : launch<__nv_bfloat16>(P, s);
}

const char* dcnErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
