// Fused MoeNet_lite2 up path + output heads for Hopper (sm_90a).
//
// Replaces the TPU kernel moephoto_tpu/ops/fusedup.py:93 fusedUpHeads
// (Pallas body _kernel :54).  For each coarse pixel row it runs every up
// stage's four per-sub-position (c, c) products with bias and PReLU,
// depth-first over the 4**nUps leaves, on the `ures` branch and then the
// `uim` branch, and sums both 1x1 heads into the (M, 4**nUps * cout)
// output whose columns are (((s1*4 + s2)*4 + ...)*cout + plane), with
// s_i = row*2 + col: the order interleaveNested expects.
//
// Rounding follows the Pallas body: fp32 products and sums, bias and
// PReLU in fp32, then a round to the working type T after every stage;
// head sums stay fp32 and are rounded once at the end.
//
// Bound on this card: at the main path's shape (c = 48, nUps = 2, bf16)
// a row moves 2*48*2 + 16*2 = 224 bytes but costs 2 * 20 * 48 * 48 MACs,
// about 820 FLOP per byte, far above the H100's ~295 FLOP/byte balance point:
// the work is bound by operations, not bytes.  The 4**nUps expansion
// never touches device memory: per block of rows, one activation vector
// per tree level lives in shared memory, the (stage, sub-position) weights
// pass through a double buffer in shared memory (the next one is copied
// with cp.async while the current one is in use), and the heads
// accumulate in fp32 in shared memory, so device traffic is the inputs
// once and the output once.
// This version runs the products on the fp32 CUDA cores: each thread
// carries an 8-row x 4-channel block of sums, so per 4 input channels it
// issues 12 shared float4 loads for 128 FMAs; a thread's rows are strided
// by T/8 and activation rows are padded by 4 floats, so the row blocks a
// warp reads fall in different banks.  Tensor cores (mma/wgmma), TMA and
// a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 192;
constexpr int kMaxTile = 128;             // pixel rows per block
constexpr int kRowBlock = 8;              // rows one thread carries through a product
constexpr int kColBlock = 4;              // output channels one thread carries
constexpr size_t kMaxSmem = 232448;       // Hopper's per-block dynamic shared memory limit

__device__ __forceinline__ float toF(float v) { return v; }
__device__ __forceinline__ float toF(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T fromF(float v);
template <> __device__ __forceinline__ float fromF<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 fromF<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T> __device__ __forceinline__ float roundTo(float v) { return toF(fromF<T>(v)); }

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cpAsyncCommit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cpAsyncWaitAll() { asm volatile("cp.async.wait_group 0;\n" ::); }

size_t smemBytes(int c, int nUps, int cout, int tileRows) {
  const size_t S = size_t(1) << (2 * nUps);
  return sizeof(float) * (2 * size_t(c) * c + size_t(nUps + 1) * tileRows * (c + 4) + size_t(tileRows) * S * cout);
}

// res, im:  (M, c) rows of the two branches, type T
// w*:       (nUps, 4, c, c) per-stage, per-sub-position weights [ci][co], fp32
//           holding values already rounded to T
// b*:       (nUps, 4, c) fp32 biases;  s*: (nUps, c) fp32 PReLU slopes
// hr, hi:   (cout, c) fp32 head rows;  hb: (cout) fp32 summed head biases
// out:      (M, 4**nUps * cout), type T
template <typename T>
__global__ void __launch_bounds__(kThreads) fusedUpHeadsKernel(
    const T* __restrict__ res, const T* __restrict__ im, long long M, int c, int nUps, int cout,
    const float* __restrict__ wRes, const float* __restrict__ bRes, const float* __restrict__ sRes,
    const float* __restrict__ wIm, const float* __restrict__ bIm, const float* __restrict__ sIm,
    const float* __restrict__ hr, const float* __restrict__ hi, const float* __restrict__ hb,
    T* __restrict__ out, int tileRows) {
  extern __shared__ float4 smem4[];
  const int ls = c + 4;                                      // padded activation row stride
  float* wS = reinterpret_cast<float*>(smem4);               // (2, c, c) double buffer
  float* lv = wS + 2 * c * c;                                // (nUps + 1, tileRows, ls)
  float* acc = lv + size_t(nUps + 1) * tileRows * ls;        // (tileRows, S * cout)
  const int G = tileRows / kRowBlock;                        // a thread's rows are rg + G*j
  const int tid = threadIdx.x;
  const int S = 1 << (2 * nUps);
  const int nOut = S * cout;
  const long long row0 = (long long)blockIdx.x * tileRows;
  const int rows = (int)min((long long)tileRows, M - row0);  // ragged last block is masked

  for (int i = tid; i < tileRows * nOut; i += blockDim.x) acc[i] = 0.f;

  for (int branch = 0; branch < 2; ++branch) {
    const T* x = branch ? im : res;
    const float* W = branch ? wIm : wRes;
    const float* B = branch ? bIm : bRes;
    const float* Sl = branch ? sIm : sRes;
    const float* H = branch ? hi : hr;
    __syncthreads();  // the previous branch is done with lv
    for (int i = tid; i < tileRows * c; i += blockDim.x) {
      const int r = i / c;
      lv[r * ls + (i - r * c)] = r < rows ? toF(x[(row0 + r) * c + (i - r * c)]) : 0.f;
    }
    auto firstK = [&](int leaf) { return leaf == 0 ? 0 : nUps - 1 - (__ffs(leaf) - 1) / 2; };
    auto issue = [&](int leaf, int k, float* dst) {
      const int sub = (leaf >> (2 * (nUps - 1 - k))) & 3;
      const float* src = W + (size_t(k) * 4 + sub) * c * c;
      for (int i = tid * 4; i < c * c; i += blockDim.x * 4) cpAsync16(dst + i, src + i);
      cpAsyncCommit();
    };
    int buf = 0;
    issue(0, 0, wS);
    for (int leaf = 0; leaf < S; ++leaf) {
      for (int k = firstK(leaf); k < nUps; ++k) {
        const int sub = (leaf >> (2 * (nUps - 1 - k))) & 3;
        cpAsyncWaitAll();
        __syncthreads();  // this node's weights are in; the last node is done
        int nl = leaf, nk = k + 1;
        if (nk == nUps) {
          nl = leaf + 1;
          nk = nl < S ? firstK(nl) : -1;
        }
        if (nk >= 0) issue(nl, nk, wS + (buf ^ 1) * c * c);
        const float* wN = wS + buf * c * c;
        buf ^= 1;
        const float* in = lv + size_t(k) * tileRows * ls;
        float* o = lv + size_t(k + 1) * tileRows * ls;
        const float* bias = B + (size_t(k) * 4 + sub) * c;
        const float* slope = Sl + size_t(k) * c;
        const int colGroups = c / kColBlock;
        for (int it = tid; it < G * colGroups; it += blockDim.x) {
          const int co = (it % colGroups) * kColBlock, rg = it / colGroups;
          float a[kRowBlock][kColBlock];
#pragma unroll
          for (int j = 0; j < kRowBlock; ++j)
#pragma unroll
            for (int q = 0; q < kColBlock; ++q) a[j][q] = 0.f;
          for (int ci = 0; ci < c; ci += 4) {
            float4 w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const float4*>(wN + (ci + q) * c + co);
#pragma unroll
            for (int j = 0; j < kRowBlock; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(in + (rg + G * j) * ls + ci);
              const float vi[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {  // input channel ci + q
                a[j][0] = fmaf(vi[q], w[q].x, a[j][0]);
                a[j][1] = fmaf(vi[q], w[q].y, a[j][1]);
                a[j][2] = fmaf(vi[q], w[q].z, a[j][2]);
                a[j][3] = fmaf(vi[q], w[q].w, a[j][3]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kRowBlock; ++j) {
            float y[kColBlock];
#pragma unroll
            for (int q = 0; q < kColBlock; ++q) {
              y[q] = a[j][q] + bias[co + q];
              y[q] = roundTo<T>(y[q] >= 0.f ? y[q] : slope[co + q] * y[q]);
            }
            *reinterpret_cast<float4*>(o + (rg + G * j) * ls + co) = make_float4(y[0], y[1], y[2], y[3]);
          }
        }
      }
      __syncthreads();
      // this branch's head for the leaf: one thread per (row, plane)
      const float* leafAct = lv + size_t(nUps) * tileRows * ls;
      for (int it = tid; it < tileRows * cout; it += blockDim.x) {
        const int r = it / cout, p = it - r * cout;
        const float* a = leafAct + r * ls;
        const float* h = H + p * c;
        float z = 0.f;
        for (int ci = 0; ci < c; ci += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a + ci);
          const float4 g = __ldg(reinterpret_cast<const float4*>(h + ci));
          z = fmaf(v.x, g.x, z);
          z = fmaf(v.y, g.y, z);
          z = fmaf(v.z, g.z, z);
          z = fmaf(v.w, g.w, z);
        }
        acc[r * nOut + leaf * cout + p] += z;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * nOut; i += blockDim.x)
    out[row0 * nOut + i] = fromF<T>(acc[i] + hb[(i % nOut) % cout]);
}

template <typename T>
int launch(const void* res, const void* im, long long M, int c, int nUps, int cout,
           const void* wRes, const void* bRes, const void* sRes,
           const void* wIm, const void* bIm, const void* sIm,
           const void* hr, const void* hi, const void* hb, void* out, void* stream) {
  if (M <= 0) return cudaSuccess;
  int tileRows = kMaxTile;
  while (tileRows > kRowBlock && smemBytes(c, nUps, cout, tileRows) > kMaxSmem) tileRows /= 2;
  const size_t smem = smemBytes(c, nUps, cout, tileRows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fusedUpHeadsKernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (M + tileRows - 1) / tileRows;
  fusedUpHeadsKernel<T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)res, (const T*)im, M, c, nUps, cout,
      (const float*)wRes, (const float*)bRes, (const float*)sRes,
      (const float*)wIm, (const float*)bIm, (const float*)sIm,
      (const float*)hr, (const float*)hi, (const float*)hb, (T*)out, tileRows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fusedUpHeadsF32(const void* res, const void* im, long long M, int c, int nUps, int cout,
                    const void* wRes, const void* bRes, const void* sRes,
                    const void* wIm, const void* bIm, const void* sIm,
                    const void* hr, const void* hi, const void* hb, void* out, void* stream) {
  return launch<float>(res, im, M, c, nUps, cout, wRes, bRes, sRes, wIm, bIm, sIm, hr, hi, hb,
                       out, stream);
}

int fusedUpHeadsBF16(const void* res, const void* im, long long M, int c, int nUps, int cout,
                     const void* wRes, const void* bRes, const void* sRes,
                     const void* wIm, const void* bIm, const void* sIm,
                     const void* hr, const void* hi, const void* hb, void* out, void* stream) {
  return launch<__nv_bfloat16>(res, im, M, c, nUps, cout, wRes, bRes, sRes, wIm, bIm, sIm, hr,
                               hi, hb, out, stream);
}

const char* fusedUpHeadsErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
