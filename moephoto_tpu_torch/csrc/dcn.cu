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
// Row windows (K3's row-sharded tier, the port of moephoto_tpu/ops/deform.py
// :225-285): a launch may cover only the output rows [out0, out0 + H) of an
// image of `full` rows, with x given as its rows [img0, img0 + imgN) (a halo
// of the sampler's row reach around the shard); offsets and mask are the
// shard's own rows.  The sampling coordinate is formed from the GLOBAL row,
// (float)(out0 + y + ky dil - pad) + dy, and a corner is inside when it lies
// in the global image, so a shard computes the single-device launch's
// values, row for row; a corner outside the window of x reads zero, which
// only a non-finite offset (NaN weight) or a halo narrower than the reach
// can reach.  The single-device launch is out0 = img0 = 0, imgN = full = H.
//
// Bound on this card: per output pixel the call must read C values of x,
// 2 dg 9 offsets and dg 9 mask values and write Cout values: 688 B at
// C = Cout = 64, dg = 8 in bf16, 0.35 ms for EDVR's full-resolution calls
// (7 x 384 x 640 pixels) at 3.35 TB/s, against 2 * 9 * C * Cout = 73.7
// kFLOP per pixel, 0.13 ms on the bf16 tensor cores: bytes bound it.  What
// the kernel pays beyond that is the gathers (4 corners x 9 taps x C values,
// 4.6 KB of L1/L2 reads a pixel) and their arithmetic, about 400 machine
// operations per (pixel, group, tap).  Offsets and mask are read through
// their pixel strides with unit channel stride, so the offset part of
// conv_offset's output is read in place.  Two instances (ops/deform.py
// pickInstance):
//
// * Tensor cores (dcnMmaKernel; bf16, C % 16 == 0, Cout % 16 == 0, 16-byte
//   corner loads, weights that fit).  The samples are already rounded to
//   bf16 before the contraction, so a bf16 mma.sync.m16n8k16 with fp32 sums
//   is the same arithmetic.  A persistent grid of one block of 16 warps per
//   SM loads the (9, C, Cout) weights once into shared memory as bf16, in the
//   order the B fragments are read (8 bytes a lane, 256 contiguous bytes a
//   warp: no bank conflicts).  A block walks over tiles of 16 x 16 pixels of
//   one image, so the corners its gathers read lie in a few rows around the
//   tile and mostly come from L1 (one block an SM leaves it ~90 KB), also
//   when offsets reach 10 pixels.  Each thread samples (pixel, group) items
//   of tap k + 1 into one of two bf16 sample buffers (16-byte stores, rows padded by 16 bytes
//   so ldmatrix reads them without bank conflicts) while the warps contract
//   tap k from the other: 16 warps as 8 pixel rows-of-32 x 2 column halves,
//   each with 2 x Cout/16 sum tiles in registers; one barrier a tap, and the
//   first tap of the next tile is sampled under the last product of this
//   one.  Pixel coordinates are split once per tile, not per item.  What
//   bounds it is the sampling: about 400 machine operations per (pixel,
//   group, tap), of which 80 are the explicitly rounded blend of 8 channels,
//   at 16 warps an SM; the contraction is under a tenth of the scheduler's
//   slots.  Two other layouts measured the same within 10 % on offsets of
//   +-2 pixels
//   (2.9 to 3.2 ms for the 7 x 384 x 640 call): two blocks of 8 warps an SM
//   over tiles of 128 pixels in a row, and tiles of 8 x 8 pixels with all
//   nine taps sampled by one thread and one barrier a tile, which left L1 so
//   little room that offsets of +-10 pixels cost 5.0 ms against 3.2.
//
// * CUDA cores (dcnKernel; fp32 and everything else): one block per 64
//   pixels and a loop over the 9 taps; per tap the threads sample the tile's
//   C channels into shared memory as fp32 and stage the tap's (C, Cout)
//   weight slice; then each thread accumulates a 4 pixel x 4 (or 8)
//   output-channel tile in fp32 registers.

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
  int out0, img0, imgN, full;  // the row window (see the header); x holds imgN rows
};

// Writes sampled values, rounded to x's type T, to a row of floats (holding
// T's values) or of T itself (bf16: one 16-byte store).
template <typename T, int V>
__device__ __forceinline__ void storeVals(float* row, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) row[i] = roundTo(v[i], T());
}
template <typename T>
__device__ __forceinline__ void storeVals(__nv_bfloat16* row, const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // nearest even, as roundTo
  *reinterpret_cast<uint4*>(row) = *reinterpret_cast<const uint4*>(h);
}
template <typename T>
__device__ __forceinline__ void storeOne(float* p, float v) { *p = roundTo(v, T()); }
template <typename T>
__device__ __forceinline__ void storeOne(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Tap {
  float dy, dx, m;  // tap k of a (pixel, group): the offset in (y, x) order and the mask value
};

__device__ __forceinline__ Tap loadTap(const Params& P, int k, long long b, int yq, int xq, int g) {
  const long long o = b * P.os.b + yq * P.os.h + xq * P.os.w + (long long)(g * 9 + k) * 2;
  Tap t;
  t.dy = loadAny(P.off, o, P.offBf16);
  t.dx = loadAny(P.off, o + 1, P.offBf16);
  t.m = loadAny(P.mask, b * P.ms.b + yq * P.ms.h + xq * P.ms.w + g * 9 + k, P.maskBf16);
  return t;
}

// Samples tap k (its offset and mask in `tap`) of group g at output pixel
// (b, yq, xq) into `row`: cg channels starting at channel g * cg, each
// rounded to x's type (R is float, holding those values, or x's type itself).
template <typename T, bool VEC, typename R>
__device__ __forceinline__ void sampleWith(const Params& P, int k, long long b, int yq, int xq, int g, const Tap tap,
                                           R* row) {
  const int cg = P.C / P.dg;
  const float dy = tap.dy, dx = tap.dx, m = tap.m;
  const int ky = k / 3, kx = k % 3;
  const float sy = __fadd_rn((float)(P.out0 + yq + ky * P.dil - P.pad), dy);
  const float sx = __fadd_rn((float)(xq + kx * P.dil - P.pad), dx);
  const float wy = __fsub_rn(sy, floorf(sy)), wx = __fsub_rn(sx, floorf(sx));
  const int yg0 = (int)floorf(clampCoord(sy, P.full)), x0 = (int)floorf(clampCoord(sx, P.W));
  const int y0 = yg0 - P.img0, y1 = y0 + 1, x1 = x0 + 1;  // rows of the window of x
  const bool inY0 = yg0 >= 0 && yg0 < P.full && y0 >= 0 && y0 < P.imgN;
  const bool inY1 = yg0 + 1 >= 0 && yg0 + 1 < P.full && y1 >= 0 && y1 < P.imgN;
  const bool inX0 = x0 >= 0 && x0 < P.W, inX1 = x1 >= 0 && x1 < P.W;
  const bool in00 = inY0 && inX0, in01 = inY0 && inX1, in10 = inY1 && inX0, in11 = inY1 && inX1;
  const T* x = reinterpret_cast<const T*>(P.x) + b * P.xs.b + (long long)g * cg;
  const long long o00 = y0 * P.xs.h + x0 * P.xs.w, o01 = o00 + P.xs.w;  // x1 = x0 + 1, y1 = y0 + 1
  const long long o10 = o00 + P.xs.h, o11 = o10 + P.xs.w;
  if constexpr (VEC) {
    constexpr int V = Vec<T>::N;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = 0; c < cg; c += V) {
      float v00[V], v01[V], v10[V], v11[V], s[V];
      Vec<T>::unpack(in00 ? __ldg(reinterpret_cast<const uint4*>(x + o00 + c)) : zero, v00);
      Vec<T>::unpack(in01 ? __ldg(reinterpret_cast<const uint4*>(x + o01 + c)) : zero, v01);
      Vec<T>::unpack(in10 ? __ldg(reinterpret_cast<const uint4*>(x + o10 + c)) : zero, v10);
      Vec<T>::unpack(in11 ? __ldg(reinterpret_cast<const uint4*>(x + o11 + c)) : zero, v11);
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = blend(v00[i], v01[i], v10[i], v11[i], wx, wy, m);
      storeVals<T>(row + c, s);
    }
  } else {
    for (int c = 0; c < cg; ++c) {
      const float v00 = in00 ? toF(x[o00 + c]) : 0.0f;
      const float v01 = in01 ? toF(x[o01 + c]) : 0.0f;
      const float v10 = in10 ? toF(x[o10 + c]) : 0.0f;
      const float v11 = in11 ? toF(x[o11 + c]) : 0.0f;
      storeOne<T>(row + c, blend(v00, v01, v10, v11, wx, wy, m));
    }
  }
}

// The same for flattened pixel p (over B, H, W).
template <typename T, bool VEC>
__device__ __forceinline__ void sampleGroup(const Params& P, int k, long long p, int g, float* row) {
  const long long b = p / ((long long)P.W * P.H);
  const int yq = (int)((p / P.W) % P.H), xq = (int)(p % P.W);
  sampleWith<T, VEC>(P, k, b, yq, xq, g, loadTap(P, k, b, yq, xq, g), row);
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

// ---- the tensor-core instance ----------------------------------------------

constexpr int kMmaThreads = 512;
constexpr int kMmaTileW = 16, kMmaTileH = 16, kMmaTileP = kMmaTileW * kMmaTileH;  // a tile: 16 x 16 pixels of one image
constexpr size_t kMaxSmem = 232448;  // Hopper's per-block dynamic shared memory limit

__device__ __forceinline__ void mmaBf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane L gives the address of
// row L % 8 of matrix L / 8 and receives, of matrix i, row L / 4, columns
// 2 (L % 4) and + 1, in r[i].
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* smemRow) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smemRow));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

size_t mmaSmemBytes(int C, int Cout) {
  return (size_t)9 * C * Cout * 2 + (size_t)2 * kMmaTileP * (C + 8) * 2 + (size_t)2 * kMmaTileP * sizeof(int4);
}

// x bf16 with 16-byte corner loads; wPacked (9, C/16, Cout/8, 32) uint2: tap
// k, k-step j, column tile n, lane (g = lane/4, t = lane%4), then
// W[k][16j+2t][8n+g] W[k][16j+2t+1][8n+g] W[k][16j+8+2t][8n+g] W[k][16j+9+2t][8n+g],
// the B fragment of mma.sync.m16n8k16.  NT = Cout / 16 column tiles a warp.
// Shared memory: the weights | two sample buffers [256][C + 8] bf16 | two
// sets of the tile's pixel coordinates.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1) dcnMmaKernel(const Params P, const uint2* __restrict__ wPacked,
                                                               int tilesX, int tilesY, long long nTiles) {
  extern __shared__ uint4 dsm[];
  const int C = P.C, CK = C / 16, NTOT = 2 * NT, rowStride = C + 8, cg = C / P.dg;
  uint2* wS = reinterpret_cast<uint2*>(dsm);
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(dsm) + (size_t)9 * C * P.Cout;
  int4* pix = reinterpret_cast<int4*>(bufs + 2 * kMmaTileP * rowStride);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 7, wn = warp >> 3;  // the warp's 32 pixels (two tile rows) and its column half
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < 9 * C * P.Cout / 8; i += kMmaThreads) cpAsync16(dsm + i, reinterpret_cast<const uint4*>(wPacked) + i);
  asm volatile("cp.async.commit_group;\n" ::);

  // (batch, y, x, inside the image) of each pixel of a tile, row by row
  auto splitPixels = [&](long long tile, int4* px) {
    if (tid < kMmaTileP) {
      const int b = (int)(tile / ((long long)tilesX * tilesY));
      const int ty = (int)((tile / tilesX) % tilesY), tx = (int)(tile % tilesX);
      const int y = ty * kMmaTileH + tid / kMmaTileW, x = tx * kMmaTileW + tid % kMmaTileW;
      px[tid] = make_int4(b, y, x, y < P.H && x < P.W ? 1 : 0);
    }
  };
  // every (pixel, group) of the tile, tap k, into buf
  auto sample = [&](int k, const int4* px, __nv_bfloat16* buf) {
    for (int it = tid; it < kMmaTileP * P.dg; it += kMmaThreads) {
      const int pl = it / P.dg, grp = it - pl * P.dg;
      const int4 q = px[pl];
      __nv_bfloat16* row = buf + pl * rowStride + grp * cg;
      if (q.w) {
        sampleWith<__nv_bfloat16, true>(P, k, q.x, q.y, q.z, grp, loadTap(P, k, q.x, q.y, q.z, grp), row);
      } else {
        for (int c = 0; c < cg; c += 8) *reinterpret_cast<uint4*>(row + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[2][NT][4];
  auto clear = [&]() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.0f;
  };
  // tap k of the tile in buf: (32 pixels, C) x (C, Cout / 2) for this warp
  const int aRow = 32 * wm + (lane & 7) + ((lane >> 3) & 1) * 8, aCol = (lane >> 4) * 8;
  auto contract = [&](int k, const __nv_bfloat16* buf) {
    const uint2* w = wS + ((size_t)k * CK * NTOT + wn * NT) * 32 + lane;
#pragma unroll 2
    for (int j = 0; j < CK; ++j) {
      uint32_t a[2][4];
      ldmatrix4(a[0], buf + aRow * rowStride + 16 * j + aCol);
      ldmatrix4(a[1], buf + (aRow + 16) * rowStride + 16 * j + aCol);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const uint2 b = w[(j * NTOT + i) * 32];
        mmaBf16(acc[0][i], a[0], b.x, b.y);
        mmaBf16(acc[1][i], a[1], b.x, b.y);
      }
    }
  };

  long long tile = blockIdx.x;
  splitPixels(tile, pix);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  sample(0, pix, bufs);
  __syncthreads();
  clear();
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(P.out);
  for (int n = 0, ti = 0; tile < nTiles; tile += gridDim.x, ++ti) {
    const long long next = tile + gridDim.x;
    int4* px = pix + (ti & 1) * kMmaTileP;
    int4* pxNext = pix + ((ti + 1) & 1) * kMmaTileP;
    for (int k = 0; k < 9; ++k, ++n) {
      // after tap 0's barrier no warp still reads the last tile's coordinates (its stores do); read at tap 8
      if (k == 1 && next < nTiles) splitPixels(next, pxNext);
      __nv_bfloat16* cur = bufs + (n & 1) * kMmaTileP * rowStride;
      __nv_bfloat16* other = bufs + ((n + 1) & 1) * kMmaTileP * rowStride;
      if (k < 8) sample(k + 1, px, other);  // the next step's samples, under this step's products
      else if (next < nTiles) sample(0, pxNext, other);
      contract(k, cur);
      __syncthreads();
    }
    // bias in fp32, one rounding, two values a store
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int4 q = px[32 * wm + 16 * m + 8 * half + g];
        if (!q.w) continue;
        __nv_bfloat16* o = out + (((long long)q.x * P.H + q.y) * P.W + q.z) * P.Cout + wn * NT * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          float v0 = acc[m][i][2 * half], v1 = acc[m][i][2 * half + 1];
          if (P.bias) {
            v0 = __fadd_rn(v0, P.bias[(wn * NT + i) * 8 + 2 * t]);
            v1 = __fadd_rn(v1, P.bias[(wn * NT + i) * 8 + 2 * t + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = __floats2bfloat162_rn(v0, v1);
        }
      }
    clear();
  }
}

template <int NT>
int launchMmaKernel(const Params& P, const void* wPacked, cudaStream_t s) {
  const size_t smem = mmaSmemBytes(P.C, P.Cout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = dcnMmaKernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  static int smsOf[64] = {};  // SM count per card, read once each
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && smsOf[dev] != 0) {
    sms = smsOf[dev];
  } else {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) smsOf[dev] = sms;
  }
  const int tilesX = (P.W + kMmaTileW - 1) / kMmaTileW, tilesY = (P.H + kMmaTileH - 1) / kMmaTileH;
  const long long nTiles = P.total / ((long long)P.H * P.W) * tilesX * tilesY;
  kernel<<<(unsigned)(nTiles < sms ? nTiles : sms), kMmaThreads, smem, s>>>(P, (const uint2*)wPacked, tilesX, tilesY,
                                                                           nTiles);
  return cudaGetLastError();
}

int launchMma(const Params& P, const void* wPacked, cudaStream_t s) {
  switch (P.Cout / 16) {
    case 1: return launchMmaKernel<1>(P, wPacked, s);
    case 2: return launchMmaKernel<2>(P, wPacked, s);
    case 3: return launchMmaKernel<3>(P, wPacked, s);
    case 4: return launchMmaKernel<4>(P, wPacked, s);
    case 5: return launchMmaKernel<5>(P, wPacked, s);
    case 6: return launchMmaKernel<6>(P, wPacked, s);
    case 7: return launchMmaKernel<7>(P, wPacked, s);
    case 8: return launchMmaKernel<8>(P, wPacked, s);
  }
  return cudaErrorInvalidValue;
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

// Types: 0 fp32, 1 bf16.  x (B, imgN, W, C) with element strides (xb, xh,
// xw, 1), the rows [img0, img0 + imgN) of an image of `full` rows; offset
// (B, H, W, 2 dg 9) and mask (B, H, W, dg 9) likewise, for the output rows
// [out0, out0 + H); bias (Cout,) fp32 or null; out contiguous (B, H, W,
// Cout) of x's type.  The single-device call is out0 = img0 = 0, imgN =
// full = H.
// instance 0 (CUDA cores): taps (9, C, Cout) contiguous of x's type.
// instance 1 (tensor cores): x bf16, C % 16 == 0, Cout % 16 == 0, (C / dg) %
// 8 == 0, x and its strides aligned to 16 bytes, taps packed as dcnMmaKernel
// documents.  Returns a cudaError_t.
int dcnForward(int instance, int xType, int offType, int maskType, const void* x, long long xb, long long xh,
               long long xw, const void* off, long long ob, long long oh, long long ow, const void* mask,
               long long mb, long long mh, long long mw, const void* taps, const float* bias, void* out,
               int B, int H, int W, int C, int Cout, int dg, int pad, int dil, int out0, int img0, int imgN,
               int full, void* stream) {
  if (out0 < 0 || out0 + H > full || img0 < 0 || imgN < 1 || img0 + imgN > full) return cudaErrorInvalidValue;
  if (B < 0 || H < 1 || W < 1 || C < 1 || C > kMaxC || Cout < 1 || Cout > kMaxCout || dg < 1 || C % dg != 0 ||
      xType < 0 || xType > 1 || offType < 0 || offType > 1 || maskType < 0 || maskType > 1 || instance < 0 ||
      instance > 1)
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
  P.out0 = out0;
  P.img0 = img0;
  P.imgN = imgN;
  P.full = full;
  cudaStream_t s = (cudaStream_t)stream;
  if (instance == 1) {
    const bool fits = xType == 1 && C % 16 == 0 && Cout % 16 == 0 && (C / dg) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 && xb % 8 == 0 && xh % 8 == 0 && xw % 8 == 0;
    return fits ? launchMma(P, taps, s) : (int)cudaErrorInvalidValue;
  }
  return xType == 0 ? launch<float>(P, s) : launch<__nv_bfloat16>(P, s);
}

const char* dcnErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
