// Adaptive-interval 3D LUT transform (AiLUT) for Hopper (sm_90a).
//
// Replaces the TPU kernel moephoto_tpu/ops/lutkernel.py:185
// ailutTransformPallasT (Pallas body _lutKernelT :113).  That kernel turns
// the lookup into hat-weight matrix products with a bf16x2 split, only
// because Mosaic cannot gather.  The card can, so this is the reference
// algorithm (ailut_transform_cuda.cu:88-159): one thread per pixel; per
// channel a lower-bound search of the value in the image's sorted vertex
// row (kept in shared memory), bin = clamp(#{v < x} - 1, 0, D - 2), and
// the fraction (x - v0) / (v1 - v0 + 1e-10) left unclamped, so values
// outside [v[0], v[D-1]] extrapolate linearly from the edge cell; then
// the 8 corners of the cell, trilinearly weighted and summed in fp32.
//
// Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn), which the compiler never contracts into an FMA
// or replaces by a reciprocal: the kernel rounds at the points where the
// plain version (ops/lut.py ailutTransformPlain) rounds, in its order.
//
// Bound on this card: per pixel 12 bytes in and 12 bytes out in fp32
// against about 80 FLOP, so bytes bound it (0.015 ms for 1080p at
// 3.35 TB/s, against ~2 us of fp32 work).  The LUT, 3 * 33^3 fp32 per
// image, does not fit a block's shared memory; the wrapper lays it out
// channel-last and padded to 4 channels (B, D, D, D, 4), 575 KB at
// D = 33, so each corner is one aligned 16-byte read through the
// read-only path, and the whole table stays in L2 across the image.
// The ragged tail of the pixel range is masked; the batch runs on
// gridDim.y.  Images are fp32 or bf16, computed in fp32, written back in
// the image's type.
//
// The Clamp instance replaces the TPU's other AiLUT kernel,
// moephoto_tpu/ops/lutkernel.py:322 ailutTransformPallas (Pallas body
// _lutKernel :58), which only the kernel parity gate runs.  That body is
// hat weights, 0/1 expansion products and a (T, D^2) x (D^2, C D) bf16
// product, again because Mosaic cannot gather; its function is the lookup
// above on r, g, b clipped to one range per image, lo = max of the three
// first vertices, hi = min of the three last.  Here each block takes lo
// and hi from the vertex rows it already holds in shared memory and clips
// as min(max(x, lo), hi) with comparisons, not fmaxf/fminf: a NaN pixel
// stays NaN, and lo > hi gives hi, as torch.clamp and the plain version
// (ailutTransformClampedPlain).  Same bytes, a few comparisons more: the
// bound is the extrapolating kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;

__device__ __forceinline__ float loadF(const float* p) { return __ldg(p); }
__device__ __forceinline__ float loadF(const __nv_bfloat16* p) { return __bfloat162float(p[0]); }
__device__ __forceinline__ void storeF(float* p, float v) { *p = v; }
__device__ __forceinline__ void storeF(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// std::lower_bound over a sorted row: the number of vertices below x.
__device__ __forceinline__ int lowerBound(const float* v, int D, float x) {
  int lo = 0, n = D;
  while (n > 0) {
    const int half = n >> 1;
    if (v[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ float4 madd4(float4 acc, float w, float4 c) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, c.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, c.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, c.z));
  return acc;
}

template <typename T, bool Clamp>
__global__ void __launch_bounds__(kThreads)
ailutKernel(const T* __restrict__ img, const float4* __restrict__ lut,
            const float* __restrict__ vertices, T* __restrict__ out, long long N, int D) {
  __shared__ float vert[3 * kMaxD];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * D; i += blockDim.x) vert[i] = vertices[(long long)b * 3 * D + i];
  __syncthreads();
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= N) return;

  const long long px = ((long long)b * N + p) * 3;
  float lo = 0.0f, hi = 0.0f;
  if (Clamp) {
    lo = fmaxf(fmaxf(vert[0], vert[D]), vert[2 * D]);
    hi = fminf(fminf(vert[D - 1], vert[2 * D - 1]), vert[3 * D - 1]);
  }
  int id[3];
  float f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = loadF(img + px + c);
    if (Clamp) {  // min(max(x, lo), hi); every comparison with NaN is false, so NaN passes
      x = (x < lo) ? lo : x;
      x = (x > hi) ? hi : x;
    }
    const float* v = vert + c * D;
    const int i0 = min(max(lowerBound(v, D, x) - 1, 0), D - 2);
    const float v0 = v[i0], v1 = v[i0 + 1];
    f[c] = __fdiv_rn(__fsub_rn(x, v0), __fadd_rn(__fsub_rn(v1, v0), 1e-10f));
    id[c] = i0;
  }
  const float rd = f[0], gd = f[1], bd = f[2];
  const float ur = __fsub_rn(1.0f, rd), ug = __fsub_rn(1.0f, gd), ub = __fsub_rn(1.0f, bd);
  const float4* L = lut + (long long)b * D * D * D + id[0] + D * (id[1] + D * id[2]);
  const int sg = D, sb = D * D;

  const float w000 = __fmul_rn(__fmul_rn(ur, ug), ub);
  float4 acc = __ldg(L);
  acc.x = __fmul_rn(w000, acc.x);
  acc.y = __fmul_rn(w000, acc.y);
  acc.z = __fmul_rn(w000, acc.z);
  acc = madd4(acc, __fmul_rn(__fmul_rn(rd, ug), ub), __ldg(L + 1));
  acc = madd4(acc, __fmul_rn(__fmul_rn(ur, gd), ub), __ldg(L + sg));
  acc = madd4(acc, __fmul_rn(__fmul_rn(rd, gd), ub), __ldg(L + sg + 1));
  acc = madd4(acc, __fmul_rn(__fmul_rn(ur, ug), bd), __ldg(L + sb));
  acc = madd4(acc, __fmul_rn(__fmul_rn(rd, ug), bd), __ldg(L + sb + 1));
  acc = madd4(acc, __fmul_rn(__fmul_rn(ur, gd), bd), __ldg(L + sb + sg));
  acc = madd4(acc, __fmul_rn(__fmul_rn(rd, gd), bd), __ldg(L + sb + sg + 1));

  storeF(out + px, acc.x);
  storeF(out + px + 1, acc.y);
  storeF(out + px + 2, acc.z);
}

template <typename T, bool Clamp>
int launch(const void* img, const void* lut4, const void* vertices, void* out, long long N, int D,
           int B, void* stream) {
  if (D < 2 || D > kMaxD || B < 1 || B > 65535 || N < 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ailutKernel<T, Clamp><<<dim3((unsigned)blocks, (unsigned)B), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)img, (const float4*)lut4, (const float*)vertices, (T*)out, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img, out: (B, N, 3) in T; lut4: (B, D, D, D, 4) fp32, 16-byte aligned;
// vertices: (B, 3, D) fp32, sorted along D.
int ailutTransformF32(const void* img, const void* lut4, const void* vertices, void* out,
                      long long N, int D, int B, void* stream) {
  return launch<float, false>(img, lut4, vertices, out, N, D, B, stream);
}

int ailutTransformBF16(const void* img, const void* lut4, const void* vertices, void* out,
                       long long N, int D, int B, void* stream) {
  return launch<__nv_bfloat16, false>(img, lut4, vertices, out, N, D, B, stream);
}

// The same on the image clipped to [max_c v_c[0], min_c v_c[D-1]].
int ailutTransformClampedF32(const void* img, const void* lut4, const void* vertices, void* out,
                             long long N, int D, int B, void* stream) {
  return launch<float, true>(img, lut4, vertices, out, N, D, B, stream);
}

int ailutTransformClampedBF16(const void* img, const void* lut4, const void* vertices, void* out,
                              long long N, int D, int B, void* stream) {
  return launch<__nv_bfloat16, true>(img, lut4, vertices, out, N, D, B, stream);
}

const char* ailutErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
