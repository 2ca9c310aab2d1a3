// Overlap-add of one chunk of tile outputs into the fp32 canvas (K7) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX engine blends with a lax.scan
// (moephoto_tpu/engine/tiling.py:246-258) that XLA fuses.  On the card the
// engine's per-tile loop cost four TensorIterator passes a tile (the cast,
// the product with the window, two in-place adds on strided slices) and
// copied each new window from the host with a blocking copy that drained
// the stream.  This kernel takes a chunk's tiles in one launch and needs no
// copy: the window is derived in the kernel from one ramp table, uploaded
// once per padSc and device, and each tile's four edge flags, passed with
// its origin by value in the launch's parameters.
//
// Window rule (ops/blend.py axisWindow, the engine's window in Python), per
// axis of t pixels, d = padSc / 2,
// r = 2 * (padSc - d), ramp = the sigmoid table of r values:
//   1 everywhere when padSc == 0; else
//   on a side that is not the image's first: 0 for i < d, ramp[i - d] for
//     d <= i < d + r;
//   on a side that is not the image's last, assigned after the first side so
//     that it wins where they meet: 0 for i >= t - d, ramp[t - d - 1 - i] for
//     t - d - r <= i < t - d;
//   1 elsewhere.
//
// One thread per canvas pixel (all its channels) of the chunk's bounding
// box.  It reads the pixel's canvas values and weight once, adds the
// contributions of the tiles that cover it in chunk order, each as the
// engine's loop forms it,
//   w = wy * wx;  c = c + float(t) * w;  wt = wt + w,
// and writes them back once; a pixel no tile covers is left alone.  Every
// fp32 operation is an explicitly rounded intrinsic that nvcc never
// contracts into an FMA, so the canvas and weight are bit-equal to the
// loop's (ops/blend.py blendTilesPlain), which adds the same rounded terms
// in the same order.  No two threads write one pixel, so there are no
// atomics; chunks follow one another on the stream.
//
// Bound on this card: bytes.  Per covered pixel the canvas and weight are
// read and written once (32 bytes at 3 channels), per tile pixel its
// values are read once (6 bytes in bf16), against a few operations; at
// 1080p x4 (4 chunks of 10 tiles of 1024x1024x3 bf16 on a 4960x7912
// canvas) about 1.5 GB an image, where the loop moved ~3.8 GB.  Tiles take
// any element strides: the channel-split planes of a Y-channel model
// (channel stride th * tw, so each channel's read is contiguous across a
// warp), NHWC outputs and a mesh's gathered outputs, in fp32 or bf16.  The
// canvas is contiguous (H, W, C) fp32, the weight contiguous (H, W, 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 256;  // 2.3 KB of parameters, inside the 4 KB a launch takes
constexpr int kGroup = 4;       // channels held in registers at once

// Edge flags: the tile's side lies on the image's first or last row or column.
constexpr unsigned kFirstY = 1, kLastY = 2, kFirstX = 4, kLastX = 8;

struct Chunk {
  int n;
  int oy[kMaxTiles], ox[kMaxTiles];  // canvas origin of each tile
  unsigned char edges[kMaxTiles];
};

struct Strides {
  long long b, h, w, c;  // elements
};

__device__ __forceinline__ float loadF(const float* p) { return __ldg(p); }
__device__ __forceinline__ float loadF(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The 1-D window at pixel i of an axis of t pixels (see the header).
__device__ __forceinline__ float axisWeight(int i, int t, bool first, bool last, const float* ramp, int d,
                                            int r) {
  if (ramp == nullptr) return 1.0f;  // padSc == 0
  float v = 1.0f;
  if (!first) {
    if (i < d) v = 0.0f;
    else if (i < d + r) v = __ldg(ramp + (i - d));
  }
  if (!last) {
    if (i >= t - d) v = 0.0f;
    else if (i >= t - d - r) v = __ldg(ramp + (t - d - 1 - i));
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
blendKernel(const __grid_constant__ Chunk ch, const T* __restrict__ tiles, Strides ts, float* __restrict__ canvas,
            float* __restrict__ weight, int W, int C, int th, int tw, int y0, int x0, int bw, long long total,
            const float* __restrict__ ramp, int d, int r) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int y = y0 + (int)(p / bw), x = x0 + (int)(p % bw);
  bool covered = false;
  for (int k = 0; k < ch.n && !covered; ++k)
    covered = y >= ch.oy[k] && y < ch.oy[k] + th && x >= ch.ox[k] && x < ch.ox[k] + tw;
  if (!covered) return;
  const long long px = (long long)y * W + x;
  float* cp = canvas + px * C;
  float wt = weight[px];
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    const int nc = min(kGroup, C - c0);
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < nc) acc[j] = cp[c0 + j];
    for (int k = 0; k < ch.n; ++k) {
      const int ly = y - ch.oy[k], lx = x - ch.ox[k];
      if (ly < 0 || ly >= th || lx < 0 || lx >= tw) continue;
      const unsigned e = ch.edges[k];
      const float wy = axisWeight(ly, th, e & kFirstY, e & kLastY, ramp, d, r);
      const float wx = axisWeight(lx, tw, e & kFirstX, e & kLastX, ramp, d, r);
      const float w = __fmul_rn(wy, wx);
      const T* tp = tiles + k * ts.b + ly * ts.h + lx * ts.w + c0 * ts.c;
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j < nc) acc[j] = __fadd_rn(acc[j], __fmul_rn(loadF(tp + j * ts.c), w));
      if (c0 == 0) wt = __fadd_rn(wt, w);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < nc) cp[c0 + j] = acc[j];
  }
  weight[px] = wt;
}

template <typename T>
int launch(const void* tiles, Strides ts, float* canvas, float* weight, int H, int W, int C, int th, int tw,
           const int* origins, const unsigned char* edges, int n, const float* ramp, int padSc, void* stream) {
  if (n < 1 || n > kMaxTiles || C < 1 || th < 1 || tw < 1 || padSc < 0 || (padSc > 0) != (ramp != nullptr))
    return cudaErrorInvalidValue;
  Chunk ch;
  ch.n = n;
  int ya = H, yb = 0, xa = W, xb = 0;
  for (int k = 0; k < n; ++k) {
    const int oy = origins[2 * k], ox = origins[2 * k + 1];
    if (oy < 0 || ox < 0 || oy + th > H || ox + tw > W) return cudaErrorInvalidValue;
    ch.oy[k] = oy;
    ch.ox[k] = ox;
    ch.edges[k] = edges[k];
    ya = std::min(ya, oy);
    yb = std::max(yb, oy + th);
    xa = std::min(xa, ox);
    xb = std::max(xb, ox + tw);
  }
  const int d = padSc / 2, r = 2 * (padSc - d);
  const int bw = xb - xa;
  const long long total = (long long)(yb - ya) * bw;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  blendKernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ch, (const T*)tiles, ts, canvas, weight, W, C, th, tw, ya, xa, bw, total, ramp, d, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tiles: n tiles of (th, tw, C) of tileType (0 fp32, 1 bf16), tile k at
// element k * sb, with element strides (sh, sw, sc); canvas: contiguous
// (H, W, C) fp32; weight: contiguous (H, W, 1) fp32; origins: n pairs
// (oy, ox), each tile inside the canvas; edges: n flag sets (1 first row,
// 2 last row, 4 first column, 8 last column of the image); ramp: the
// device table of 2 * (padSc - padSc / 2) values, or null when padSc is 0.
// Origins and edges are host arrays, passed to the kernel by value.  One
// launch for 1 <= n <= kMaxTiles (ops/blend.py MAX_TILES).  Returns a
// cudaError_t.
int blendTiles(int tileType, const void* tiles, long long sb, long long sh, long long sw, long long sc,
               float* canvas, float* weight, int H, int W, int C, int th, int tw, const int* origins,
               const unsigned char* edges, int n, const float* ramp, int padSc, void* stream) {
  const Strides ts{sb, sh, sw, sc};
  if (tileType == 0)
    return launch<float>(tiles, ts, canvas, weight, H, W, C, th, tw, origins, edges, n, ramp, padSc, stream);
  if (tileType == 1)
    return launch<__nv_bfloat16>(tiles, ts, canvas, weight, H, W, C, th, tw, origins, edges, n, ramp, padSc,
                                 stream);
  return cudaErrorInvalidValue;
}

const char* blendErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
