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
// the work is bound by operations, not bytes.  The 4**nUps expansion never
// touches device memory in any instance below; device traffic is the
// inputs once and the output once.
//
// Three instances, chosen by the wrapper (ops/fusedup.py pickInstance).  The
// two on the tensor cores share this: a warp carries 16-row tiles depth-first
// down the tree entirely in registers, because the fp32 sums of one node,
// after PReLU and packing to bf16 pairs, already have the register layout of
// the A operand of the next node's product (sum tiles 2j and 2j + 1 are the
// four A registers of k-step j).  No activation passes through shared memory
// and no block-wide barrier separates two nodes.  The stage weights stay in
// shared memory as bf16 for the life of a persistent block (one per SM,
// loaded once with cp.async), warps or warpgroups walk over row tiles on
// their own, and each warp's fp32 output tile in shared memory is rounded
// once and written with 16-byte stores.
//
// * wgmma (fusedUpHeadsWgmmaKernel; bf16, c = 48, cout <= 2: the main path).
//   A warpgroup takes 64 rows and walks both branches in step.  A node is,
//   per branch, four asynchronous wgmma.m64n48k16 with A from registers and B
//   read from shared memory by descriptor (core-matrix layout made by the
//   host).  The fourth k-step is the bias: A holds ones and B the fp32 bias
//   as three bf16 terms whose sum is the bias exactly, so the sums need no
//   initial value.  The epilogue is then PReLU (two operations a value when
//   a stage's slopes are one number in [0, 1]) and the pack.  At a leaf the
//   heads run as six mma.sync.m16n8k16 on the packed leaf values of both
//   branches against the fp32 head rows, split the same way into three bf16
//   terms and held in registers as B fragments: fp32 sums over both branches
//   with no shuffle tree, no unpacking and no read-modify-write of the tile.
//   What bounds it now is the operation count of the epilogue and the
//   latency of a warpgroup's serial chain (products, wait, epilogue) with 12
//   warps an SM.
//
// * mma.sync (fusedUpHeadsMmaKernel; bf16, c = 96, cout <= 4: the packed
//   models).  A warp owns 16 rows and walks one branch after the other;
//   products are mma.sync.m16n8k16, B fragments come from shared memory in
//   the order they are read (one 16-byte load a lane feeds two 8-column
//   tiles; no bank conflicts), or through L1 when both branches' weights do
//   not fit (nUps > 1: 295 KB and more).  The bias is the initial value of
//   the sums; heads are fp32 FMAs on the values a lane holds, finished by two
//   quad shuffles.  The same kernel at c = 48 with 32 rows a warp took 1.77
//   ms at the main shape, against the wgmma instance's 1.28.
//
// * CUDA cores (fusedUpHeadsKernel; fp32, and any c that is a multiple of 4):
//   per block of rows one activation vector per tree level lives in shared
//   memory, the (stage, sub-position) weights pass through a double buffer
//   (the next one is copied with cp.async while the current one is in use),
//   and the heads accumulate in fp32 in shared memory.  Each thread carries
//   an 8-row x 4-channel block of sums through scalar fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- the tensor-core instances ---------------------------------------------
//
// Shared by both: a warp carries 16-row tiles down the tree with one A
// fragment per level in registers.  With g = lane / 4 and t = lane % 4 a
// lane holds, of a 16 x 16 bf16 A tile, a 16 x 8 B tile and a 16 x 8 fp32
// sum tile (mma.sync.m16n8k16; wgmma.m64nNk16 gives each of its four warps
// the same A and sum layout for its 16 rows, the sum tiles side by side):
//   A: a0 (row g, k 2t..2t+1)  a1 (row g+8, same k)  a2 (row g, k 2t+8..)  a3 (row g+8, k 2t+8..)
//   B: b0 (k 2t..2t+1, column g)  b1 (k 2t+8.., column g)
//   D: d0 d1 (row g, columns 2t, 2t+1)  d2 d3 (row g+8, same columns)
// so the sums of tiles 2j and 2j + 1, packed to bf16 pairs, are the A
// registers of k-step j of the next product.

constexpr int kMmaWarps = 12;  // mma.sync kernel: warps per block, 16 rows each
// one block per SM either way

extern __shared__ uint4 mmaSmem[];  // weights (when resident) | fp32 block | one output tile per warp

__device__ __forceinline__ void mmaBf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma.m64n48k16: D (64 x 48, fp32, 16 rows a warp) and A (64 x 16, from
// registers) as above, B (16 x 48) from shared memory through a matrix
// descriptor; asynchronous.
// D = A * B: the first product of a chain; D's registers need not be set.
__device__ __forceinline__ void wgmma48First(float (&d)[6][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
        "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
        "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
        "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
        "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
        "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0)  // the last: scale of D
      : "memory");
}
// D += A * B.
__device__ __forceinline__ void wgmma48(float (&d)[6][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)  // the last: scale of D
      : "memory");
}

__device__ __forceinline__ void wgmmaFence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmmaCommit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmmaWaitAll() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Descriptor of a B operand without swizzle: 8 x 8 core matrices of 128
// contiguous bytes (8 columns n, each 8 consecutive k); `kStep` bytes from a
// core matrix to the next one along k, `nStep` bytes to the next along n.
__device__ __forceinline__ uint64_t wgmmaDesc(uint32_t smemAddr, uint32_t kStep, uint32_t nStep) {
  return (uint64_t)((smemAddr & 0x3ffffu) >> 4) | ((uint64_t)(kStep >> 4) << 16) | ((uint64_t)(nStep >> 4) << 32);
}

// Two fp32 values rounded to nearest even and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t packBf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One branch as a warp sees it while it walks the tree.  Shared memory is
// addressed by offsets into mmaSmem, so every access is a shared load.
struct MmaBranch {
  const uint4* wGlobal;  // packed stage weights of the branch when they are not resident
  int wOff;              // the same in mmaSmem, in uint4s: [stage][sub][...]
  int fOff;              // the branch's fp32 block in mmaSmem, in floats: biases, slopes, head rows
  int tileOff;           // the warp's output tile [rows][stride] in mmaSmem, in floats
  int cout, stride;
  bool add;              // the second branch adds to what the first one stored
  bool slope01;          // every slope lies in [0, 1]: PReLU is max(y, slope * y)
  int lane;
};

// mma.sync: the sums of a node start as its bias.
template <int C, int NUPS>
__device__ __forceinline__ void biasInit(float (&acc)[C / 8][4], const MmaBranch& br, int node) {
  const float* bias = reinterpret_cast<const float*>(mmaSmem) + br.fOff + node * C + 2 * (br.lane & 3);
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i);
    acc[i][0] = b.x;
    acc[i][1] = b.y;
    acc[i][2] = b.x;
    acc[i][3] = b.y;
  }
}

// mma.sync: PReLU in fp32 with stage K's slopes, then the stage's one
// rounding to bf16: as pairs, which are the next product's A operand.
template <int C, int NUPS>
__device__ __forceinline__ void preluPack(float (&acc)[C / 8][4], uint32_t (&next)[C / 16][4], const MmaBranch& br,
                                          int K) {
  const float* slope = reinterpret_cast<const float*>(mmaSmem) + br.fOff + NUPS * 4 * C + K * C + 2 * (br.lane & 3);
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const float2 s = *reinterpret_cast<const float2*>(slope + 8 * i);
    float(&v)[4] = acc[i];
    if (br.slope01) {
      v[0] = fmaxf(v[0], s.x * v[0]);
      v[1] = fmaxf(v[1], s.y * v[1]);
      v[2] = fmaxf(v[2], s.x * v[2]);
      v[3] = fmaxf(v[3], s.y * v[3]);
    } else {
      v[0] = v[0] >= 0.f ? v[0] : s.x * v[0];
      v[1] = v[1] >= 0.f ? v[1] : s.y * v[1];
      v[2] = v[2] >= 0.f ? v[2] : s.x * v[2];
      v[3] = v[3] >= 0.f ? v[3] : s.y * v[3];
    }
  }
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    next[j][0] = packBf16(acc[2 * j][0], acc[2 * j][1]);
    next[j][1] = packBf16(acc[2 * j][2], acc[2 * j][3]);
    next[j][2] = packBf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    next[j][3] = packBf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

// mma.sync, a leaf: this branch's head on the rounded values `v`, in fp32
// with fp32 head rows.  Each lane sums the columns it holds, two quad
// shuffles finish the C-long sums, and one lane of the quad per row stores
// into (first branch) or adds to (second) the warp's output tile.
template <int C, int NUPS>
__device__ __forceinline__ void leafHeads(const uint32_t (&v)[C / 16][4], const MmaBranch& br, int leaf) {
  const int g = br.lane >> 2, t = br.lane & 3;
  float* tile = reinterpret_cast<float*>(mmaSmem) + br.tileOff;
  const float* head = reinterpret_cast<const float*>(mmaSmem) + br.fOff + NUPS * 5 * C + 2 * t;
  for (int p = 0; p < br.cout; ++p) {
    const float* h = head + p * C;
    float z[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll
    for (int j = 0; j < C / 16; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // sum tile 2j + q: columns 16j + 8q + 2t, + 1
        const float2 hv = *reinterpret_cast<const float2*>(h + 16 * j + 8 * q);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t pair = v[j][2 * q + half];
          z[half] = fmaf(__uint_as_float(pair << 16), hv.x, z[half]);
          z[half] = fmaf(__uint_as_float(pair & 0xffff0000u), hv.y, z[half]);
        }
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = z[half];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == half) {
        float* dst = tile + (half * 8 + g) * br.stride + leaf * br.cout + p;
        *dst = br.add ? *dst + s : s;
      }
    }
  }
}

// The A fragments of the 16 rows of x from row0 on (rows past M read 0).
template <int C>
__device__ __forceinline__ void loadRows(uint32_t (&a)[C / 16][4], const __nv_bfloat16* x, long long row0, long long M,
                                         int lane) {
  const uint32_t* x2 = reinterpret_cast<const uint32_t*>(x);  // bf16 pairs
  const long long rA = row0 + (lane >> 2), rB = rA + 8;
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    const int col = 8 * j + (lane & 3);
    a[j][0] = rA < M ? __ldg(x2 + rA * (C / 2) + col) : 0u;
    a[j][1] = rB < M ? __ldg(x2 + rB * (C / 2) + col) : 0u;
    a[j][2] = rA < M ? __ldg(x2 + rA * (C / 2) + col + 4) : 0u;
    a[j][3] = rB < M ? __ldg(x2 + rB * (C / 2) + col + 4) : 0u;
  }
}

// Writes the warp's finished tile: its valid rows are contiguous in `out`;
// the summed head bias is added, one rounding, 16 bytes a lane.
__device__ __forceinline__ void storeTile(const float* tile, const float* hb, __nv_bfloat16* out, long long row0,
                                          long long M, int rows, int nOut, int cout, int stride, int lane) {
  __syncwarp();
  const long long valid = min((long long)rows, M - row0) * nOut;
  __nv_bfloat16* dst = out + row0 * nOut;
  for (int e0 = lane * 8; e0 < valid; e0 += 32 * 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = min(e0 + q, rows * nOut - 1), r = e / nOut, col = e - r * nOut;
      v[q] = tile[r * stride + col] + hb[col % cout];
    }
    if (e0 + 8 <= valid) {
      uint4 pk;
      pk.x = packBf16(v[0], v[1]);
      pk.y = packBf16(v[2], v[3]);
      pk.z = packBf16(v[4], v[5]);
      pk.w = packBf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(dst + e0) = pk;
    } else {
      for (int q = 0; e0 + q < valid; ++q) dst[e0 + q] = __float2bfloat16(v[q]);
    }
  }
  __syncwarp();  // before the next tile's heads overwrite this one
}

// Copies the resident weights and the fp32 block into shared memory.
__device__ __forceinline__ void loadShared(const uint4* wPacked, int wCount, const float* fparams, float* fS,
                                           int fCount) {
  for (int i = threadIdx.x; i < wCount; i += blockDim.x) cpAsync16(mmaSmem + i, wPacked + i);
  for (int i = threadIdx.x * 4; i < fCount; i += blockDim.x * 4) cpAsync16(fS + i, fparams + i);
  cpAsyncCommit();
  cpAsyncWaitAll();
  __syncthreads();  // the only block-wide barrier: from here on warps (or warpgroups) work alone
}

// mma.sync: runs stage K on the 16 rows whose A fragments are `a`, for each
// of the four sub-positions in turn, and descends; `leaf` is the index of
// the path so far.  Loops over sub-positions stay rolled, so the code holds
// one node body per stage, while every register array is indexed by
// constants.  Weights: per (stage, sub) [k-step j][tile pair i2][lane] uint4 =
// the B fragments b0 b1 of sum tile 2 i2 and b0 b1 of tile 2 i2 + 1.
template <int C, int NUPS, int K, bool WSMEM>
__device__ __forceinline__ void descend(const uint32_t (&a)[C / 16][4], const MmaBranch br, int leaf) {
  constexpr int KS = C / 16;
#pragma unroll 1
  for (int sub = 0; sub < 4; ++sub) {
    float acc[C / 8][4];
    biasInit<C, NUPS>(acc, br, K * 4 + sub);
    const int wAt = (K * 4 + sub) * (KS * KS * 32) + br.lane;
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i2 = 0; i2 < KS; ++i2) {
        uint4 b;
        if constexpr (WSMEM) b = mmaSmem[br.wOff + wAt + (j * KS + i2) * 32];
        else b = __ldg(br.wGlobal + wAt + (j * KS + i2) * 32);
        mmaBf16(acc[2 * i2], a[j], b.x, b.y);
        mmaBf16(acc[2 * i2 + 1], a[j], b.z, b.w);
      }
    uint32_t next[KS][4];
    preluPack<C, NUPS>(acc, next, br, K);
    if constexpr (K + 1 < NUPS) descend<C, NUPS, K + 1, WSMEM>(next, br, leaf * 4 + sub);
    else leafHeads<C, NUPS>(next, br, leaf * 4 + sub);
  }
}

// ---- wgmma (c = 48): a warpgroup walks 64 rows, 16 a warp, both branches
// in step, so a leaf's two heads meet in registers.  Per node and branch:
// four asynchronous m64n48k16 products that read B from shared memory by
// descriptor.  The fourth k-step carries the bias: A has ones in columns
// 48..50 and B has there the fp32 bias split into three bf16 terms (hi + mid
// + lo is the bias exactly), so the sums need no initial value and no add.
// Weights: per (branch, stage, sub) a (64, 48) bf16 matrix [k][n] as 8 x 8
// core matrices of 128 bytes: [k-step j][k half][column block][column][8 k].
// The heads run on mma.sync with A the leaf's packed values and B, held in
// registers for the whole kernel, the fp32 head rows split in three bf16
// terms in columns (p0: 0 1 2, p1: 4 5 6): a lane adds its two columns and
// its neighbour's, which is the row's fp32 sum over both branches.

constexpr int kWgC = 48, kWgKS = 3, kWgMatBytes = 64 * 48 * 2, kWgHalfBytes = 6 * 128;
template <int NUPS> constexpr int kWgWarps = NUPS == 3 ? 8 : 12;  // whole warpgroups; registers bound it

template <int NUPS>
struct WgCtx {
  uint32_t wAddr[2];             // shared address of each branch's stage weights
  uint32_t headB[2][kWgKS][2];   // the heads' B fragments
  float slopeS[2][NUPS];         // the stage's slope when it is one number in [0, 1] (`fast`)
  int slopeOff;                  // else: slopes [branch][stage][c] in mmaSmem, in floats
  int tileOff;                   // the warp's output tile [16][stride] in mmaSmem, in floats
  int cout, stride, lane;
  bool fast;
  uint32_t zero;                 // 0, known only at run time
};

template <int NUPS, int K>
__device__ __forceinline__ void preluPack48(float (&acc)[6][4], uint32_t (&next)[kWgKS][4], const WgCtx<NUPS>& cx,
                                            int branch) {
  if (cx.fast) {
    const float s = cx.slopeS[branch][K];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaxf(acc[i][q], s * acc[i][q]);
  } else {
    const float* slope = reinterpret_cast<const float*>(mmaSmem) + cx.slopeOff + (branch * NUPS + K) * kWgC +
                         2 * (cx.lane & 3);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float2 s = *reinterpret_cast<const float2*>(slope + 8 * i);
      float(&v)[4] = acc[i];
      v[0] = v[0] >= 0.f ? v[0] : s.x * v[0];
      v[1] = v[1] >= 0.f ? v[1] : s.y * v[1];
      v[2] = v[2] >= 0.f ? v[2] : s.x * v[2];
      v[3] = v[3] >= 0.f ? v[3] : s.y * v[3];
    }
  }
#pragma unroll
  for (int j = 0; j < kWgKS; ++j) {
    next[j][0] = packBf16(acc[2 * j][0], acc[2 * j][1]);
    next[j][1] = packBf16(acc[2 * j][2], acc[2 * j][3]);
    next[j][2] = packBf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    next[j][3] = packBf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

template <int NUPS, int K>
__device__ __forceinline__ void descend2(const uint32_t (&aR)[kWgKS][4], const uint32_t (&aI)[kWgKS][4],
                                         const WgCtx<NUPS>& cx, int leaf) {
  const int g = cx.lane >> 2, t = cx.lane & 3;
#pragma unroll 1
  for (int sub = 0; sub < 4; ++sub) {
    // The products read copies of the A registers, made anew for every
    // node: ptxas (CUDA 12.8) reuses the registers of a fragment that stays
    // the same over the loop once a product has read it, although the next
    // sub-position reads it again.  The copy is an XOR with 0 & sub, a zero
    // that neither compiler stage can fold or move out of the loop.
    const uint32_t z = cx.zero & static_cast<uint32_t>(sub);
    uint32_t ac[2][kWgKS + 1][4];
#pragma unroll
    for (int j = 0; j < kWgKS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ac[0][j][q] = aR[j][q] ^ z;
        ac[1][j][q] = aI[j][q] ^ z;
      }
    // the bias k-step: ones in columns 48, 49 (t = 0) and 50 (t = 1) of both row halves
    const uint32_t ones = (t == 0 ? 0x3f803f80u : t == 1 ? 0x00003f80u : 0u) ^ z;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      ac[b][kWgKS][0] = ones;
      ac[b][kWgKS][1] = ones;
      ac[b][kWgKS][2] = z;
      ac[b][kWgKS][3] = z;
    }
    float acc[2][6][4];
    wgmmaFence();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint32_t w = cx.wAddr[b] + (K * 4 + sub) * kWgMatBytes;
      wgmma48First(acc[b], ac[b][0], wgmmaDesc(w, kWgHalfBytes, 128));
#pragma unroll
      for (int j = 1; j <= kWgKS; ++j) wgmma48(acc[b], ac[b][j], wgmmaDesc(w + j * 2 * kWgHalfBytes, kWgHalfBytes, 128));
    }
    wgmmaCommit();
    wgmmaWaitAll();
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(acc[b][i][q])::"memory");  // no read of a sum moves above the wait
    uint32_t next[2][kWgKS][4];
    preluPack48<NUPS, K>(acc[0], next[0], cx, 0);
    preluPack48<NUPS, K>(acc[1], next[1], cx, 1);
    if constexpr (K + 1 < NUPS) {
      descend2<NUPS, K + 1>(next[0], next[1], cx, leaf * 4 + sub);
    } else {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int j = 0; j < kWgKS; ++j) mmaBf16(d, next[b][j], cx.headB[b][j][0], cx.headB[b][j][1]);
      float top = d[0] + d[1], bot = d[2] + d[3];  // rows g, g + 8: two of the plane's three terms, or the third
      top += __shfl_xor_sync(0xffffffffu, top, 1);
      bot += __shfl_xor_sync(0xffffffffu, bot, 1);
      if ((t & 1) == 0 && (t >> 1) < cx.cout) {
        float* dst = reinterpret_cast<float*>(mmaSmem) + cx.tileOff + g * cx.stride + (leaf * 4 + sub) * cx.cout + (t >> 1);
        dst[0] = top;
        dst[8 * cx.stride] = bot;
      }
    }
  }
}

// Floats of the fp32 block: per branch the biases, slopes and head rows,
// then the summed head bias, padded to a multiple of 4.
int mmaFloatCount(int c, int nUps, int cout) { return (2 * (nUps * 5 * c + cout * c) + cout + 3) / 4 * 4; }

size_t mmaSmemBytes(int c, int nUps, int cout, bool wSmem) {
  const size_t S = size_t(1) << (2 * nUps);
  const size_t weights = wSmem ? size_t(2) * nUps * 4 * c * c * sizeof(__nv_bfloat16) : 0;
  return weights + sizeof(float) * (mmaFloatCount(c, nUps, cout) + size_t(kMmaWarps) * 16 * (S * cout + 1));
}

// res, im:  (M, C) bf16 rows;  out: (M, 4**NUPS * cout) bf16
// wPacked:  (2, NUPS, 4, C * C) bf16: branch, stage, sub-position, then the
//           order `descend` documents
// fparams:  fp32: per branch (NUPS, 4, C) biases, (NUPS, C) slopes, (cout, C)
//           head rows; then (cout) summed head biases; fCount floats in all
template <int C, int NUPS, bool WSMEM>
__global__ void __launch_bounds__(kMmaWarps * 32, 1) fusedUpHeadsMmaKernel(
    const __nv_bfloat16* __restrict__ res, const __nv_bfloat16* __restrict__ im, long long M, int cout,
    const uint4* __restrict__ wPacked, const float* __restrict__ fparams, int fCount, int slope01,
    __nv_bfloat16* __restrict__ out) {
  constexpr int S = 1 << (2 * NUPS);
  constexpr int WB = NUPS * 4 * C * C / 8;       // uint4s of one branch's weights
  constexpr int fBase = WSMEM ? 2 * WB * 4 : 0;  // the fp32 block in mmaSmem, in floats
  float* fS = reinterpret_cast<float*>(mmaSmem) + fBase;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  loadShared(wPacked, WSMEM ? 2 * WB : 0, fparams, fS, fCount);

  const int nOut = S * cout, stride = nOut + 1;  // the pad spreads a tile's rows over the banks
  const int fBranch = NUPS * 5 * C + cout * C;
  const int tileOff = fBase + fCount + warp * 16 * stride;
  const long long nTiles = (M + 15) / 16;
  for (long long tl = (long long)blockIdx.x * kMmaWarps + warp; tl < nTiles; tl += (long long)gridDim.x * kMmaWarps) {
    const long long row0 = tl * 16;
#pragma unroll 1
    for (int branch = 0; branch < 2; ++branch) {
      uint32_t a[C / 16][4];
      loadRows<C>(a, branch ? im : res, row0, M, lane);
      const MmaBranch br{wPacked + branch * WB, branch * WB, fBase + branch * fBranch, tileOff, cout, stride,
                         branch == 1, slope01 != 0, lane};
      descend<C, NUPS, 0, WSMEM>(a, br, 0);
    }
    storeTile(reinterpret_cast<const float*>(mmaSmem) + tileOff, fS + 2 * fBranch, out, row0, M, 16, nOut, cout, stride,
              lane);
  }
}

// wgmma kernel, c = 48, cout <= 2.
// wPacked: (2, NUPS, 4, 64 * 48) bf16, the order `descend2` documents
// headFrag: (2, 3, 32) uint2: branch, k-step, lane: the heads' B fragments
// fparams: fp32 (2, NUPS, 48) slopes, then (cout) summed head biases
template <int NUPS>
__global__ void __launch_bounds__(kWgWarps<NUPS> * 32, 1) fusedUpHeadsWgmmaKernel(
    const __nv_bfloat16* __restrict__ res, const __nv_bfloat16* __restrict__ im, long long M, int cout,
    const uint4* __restrict__ wPacked, const uint2* __restrict__ headFrag, const float* __restrict__ fparams,
    int fCount, int fast, __nv_bfloat16* __restrict__ out, uint32_t zero) {
  constexpr int S = 1 << (2 * NUPS), WARPS = kWgWarps<NUPS>;
  constexpr int WB = NUPS * 4 * kWgMatBytes / 16;  // uint4s of one branch's weights
  constexpr int fBase = 2 * WB * 4;                // the fp32 block in mmaSmem, in floats
  float* fS = reinterpret_cast<float*>(mmaSmem) + fBase;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, group = warp >> 2;
  loadShared(wPacked, 2 * WB, fparams, fS, fCount);

  const int nOut = S * cout, stride = nOut + 1;
  WgCtx<NUPS> cx;
  const uint32_t wBase = static_cast<uint32_t>(__cvta_generic_to_shared(mmaSmem));
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    cx.wAddr[b] = wBase + b * WB * 16;
#pragma unroll
    for (int j = 0; j < kWgKS; ++j) {
      const uint2 h = __ldg(headFrag + (b * kWgKS + j) * 32 + lane);
      cx.headB[b][j][0] = h.x;
      cx.headB[b][j][1] = h.y;
    }
#pragma unroll
    for (int k = 0; k < NUPS; ++k) cx.slopeS[b][k] = fS[(b * NUPS + k) * kWgC];
  }
  cx.slopeOff = fBase;
  cx.tileOff = fBase + fCount + warp * 16 * stride;
  cx.cout = cout;
  cx.stride = stride;
  cx.lane = lane;
  cx.fast = fast != 0;
  cx.zero = zero;
  const float* hb = fS + 2 * NUPS * kWgC;
  const long long nTiles = (M + 63) / 64;  // a warpgroup takes 64 rows: every warp of it runs every product
  for (long long tl = (long long)blockIdx.x * (WARPS / 4) + group; tl < nTiles; tl += (long long)gridDim.x * (WARPS / 4)) {
    const long long row0 = tl * 64 + (warp & 3) * 16;
    uint32_t aR[kWgKS][4], aI[kWgKS][4];
    loadRows<kWgC>(aR, res, row0, M, lane);
    loadRows<kWgC>(aI, im, row0, M, lane);
    descend2<NUPS, 0>(aR, aI, cx, 0);
    if (row0 < M)
      storeTile(reinterpret_cast<const float*>(mmaSmem) + cx.tileOff, hb, out, row0, M, 16, nOut, cout, stride, lane);
  }
}

struct MmaArgs {
  const void *res, *im;
  long long M;
  int cout;
  const void *wPacked, *fparams;
  int slope01;
  void* out;
  int sms;
  cudaStream_t stream;
};

template <typename Kernel>
int launchMmaKernel(Kernel kernel, const MmaArgs& a, int c, int nUps, int blockRows, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long want = (a.M + blockRows - 1) / blockRows;
  kernel<<<(int)(want < a.sms ? want : a.sms), kMmaWarps * 32, smem, a.stream>>>(
      (const __nv_bfloat16*)a.res, (const __nv_bfloat16*)a.im, a.M, a.cout, (const uint4*)a.wPacked,
      (const float*)a.fparams, mmaFloatCount(c, nUps, a.cout), a.slope01, (__nv_bfloat16*)a.out);
  return cudaGetLastError();
}

template <int NUPS>
int launchMma(const MmaArgs& a) {
  constexpr int C = 96;
  const size_t both = mmaSmemBytes(C, NUPS, a.cout, true);
  if (both <= kMaxSmem) return launchMmaKernel(fusedUpHeadsMmaKernel<C, NUPS, true>, a, C, NUPS, kMmaWarps * 16, both);
  return launchMmaKernel(fusedUpHeadsMmaKernel<C, NUPS, false>, a, C, NUPS, kMmaWarps * 16,
                         mmaSmemBytes(C, NUPS, a.cout, false));
}

int wgFloatCount(int nUps, int cout) { return (2 * nUps * kWgC + cout + 3) / 4 * 4; }

template <int NUPS>
int launchWgmma(const MmaArgs& a, const void* headFrag) {
  constexpr int WARPS = kWgWarps<NUPS>;
  const int fCount = wgFloatCount(NUPS, a.cout);
  const size_t S = size_t(1) << (2 * NUPS);
  const size_t smem = size_t(2) * NUPS * 4 * kWgMatBytes + sizeof(float) * (fCount + size_t(WARPS) * 16 * (S * a.cout + 1));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = fusedUpHeadsWgmmaKernel<NUPS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long want = (a.M + WARPS * 16 - 1) / (WARPS * 16);
  kernel<<<(int)(want < a.sms ? want : a.sms), WARPS * 32, smem, a.stream>>>(
      (const __nv_bfloat16*)a.res, (const __nv_bfloat16*)a.im, a.M, a.cout, (const uint4*)a.wPacked,
      (const uint2*)headFrag, (const float*)a.fparams, fCount, a.slope01, (__nv_bfloat16*)a.out, 0u);
  return cudaGetLastError();
}

// The current card's SM count, read once per card.
int smCount(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached[dev];
  return cudaSuccess;
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

// The mma.sync instance: bf16 rows, c = 96, nUps 1..3, cout 1..4.  wPacked
// and fparams as fusedUpHeadsMmaKernel documents them; slope01 says that
// every PReLU slope lies in [0, 1].  The grid is one block per SM, or fewer
// when the rows need fewer.  All pointers 16-byte aligned.
int fusedUpHeadsBF16Mma(const void* res, const void* im, long long M, int nUps, int cout, const void* wPacked,
                        const void* fparams, int slope01, void* out, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (cout < 1 || cout > 4) return cudaErrorInvalidValue;
  int sms = 0;
  if (int e = smCount(&sms)) return e;
  const MmaArgs a{res, im, M, cout, wPacked, fparams, slope01, out, sms, (cudaStream_t)stream};
  switch (nUps) {
    case 1: return launchMma<1>(a);
    case 2: return launchMma<2>(a);
    case 3: return launchMma<3>(a);
  }
  return cudaErrorInvalidValue;
}

// The wgmma instance: bf16 rows, c = 48, nUps 1..3, cout 1..2.  wPacked,
// headFrag and fparams as fusedUpHeadsWgmmaKernel documents them; `fast` says
// that every stage's slopes are one number in [0, 1].
int fusedUpHeadsBF16Wgmma(const void* res, const void* im, long long M, int nUps, int cout, const void* wPacked,
                          const void* headFrag, const void* fparams, int fast, void* out, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (cout < 1 || cout > 2) return cudaErrorInvalidValue;
  int sms = 0;
  if (int e = smCount(&sms)) return e;
  const MmaArgs a{res, im, M, cout, wPacked, fparams, fast, out, sms, (cudaStream_t)stream};
  switch (nUps) {
    case 1: return launchWgmma<1>(a, headFrag);
    case 2: return launchWgmma<2>(a, headFrag);
    case 3: return launchWgmma<3>(a, headFrag);
  }
  return cudaErrorInvalidValue;
}

const char* fusedUpHeadsErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
