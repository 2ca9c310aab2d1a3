// NAFNet's LayerNorm over the channels of a channels-last tensor (K8) for
// Hopper (sm_90a), with the block's scaled residual taken into the second
// norm.
//
// Replaces no TPU kernel: the JAX package's layerNorm2d
// (moephoto_tpu/models/api.py:168) is jnp that XLA fuses.  On the card the
// port called F.layer_norm on the channels-last view, whose kernel gives
// each row (one pixel's C = 32-512 channels) a whole thread block, so at
// C = 32 a block shares 64 bytes of work; it ran at ~6 % of its byte bound
// in the NAFNet cell.
//
// Two modes, both on rows of C values, each row one pixel of an NHWC
// tensor:
//   (a) n = LN(x);
//   (b) z = x + (y + yBias) * scale, formed in fp32 with explicitly rounded
//       operations (no FMA contraction, so z is bit-equal to the same
//       operations in torch) and rounded once to the dtype; z is written,
//       then n = LN(z) from that rounded z, so n equals (a) on the written z.
// LN: mean, then the biased variance from the registers (two passes over
// values held in registers, both in fp32), n = (v - mean) * rsqrt(var +
// eps) * weight + bias in fp32, rounded once to the dtype.
//
// Bound on this card: bytes.  (a) reads and writes each value once, (b)
// reads x and y and writes z and n; a few operations a value.  The design
// moves only those bytes: a group of G = 4, 8, 16 or 32 lanes serves one
// row with 16-byte vector loads (G the row's vectors rounded up to a power
// of two, at most 32; above 32 vectors a lane holds several), the row stays
// in registers between the reduction and the output, and the sums are
// shuffles within the group.  At C = 32 in bf16 a warp serves 8 rows; at
// C >= 256 a warp serves one.  Each thread loads its channels' weight and
// bias (and in (b) yBias and scale) once; the blocks stride over the rows,
// two rows a pass where a lane holds one vector so that more loads are in
// flight, with as many blocks as the SMs hold at once (the occupancy the
// runtime reports for the instance, asked once).  Rows of C a multiple of 8
// from 32 to 1024, fp32 or bf16; x, y, z and n 16-byte aligned (the
// wrapper, ops/layernorm.py, checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;  // values in 16 bytes
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float round(float f) { return f; }
  static __device__ __forceinline__ float scalar(const float* p, int i) { return __ldg(p + i); }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  static __device__ __forceinline__ float round(float f) { return __bfloat162float(__float2bfloat16_rn(f)); }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p, int i) {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
  }
};

// Sum over the G aligned lanes of a group; every lane of the warp takes part.
template <int G>
__device__ __forceinline__ float groupSum(float s) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// G lanes a row, VPL vectors a lane, R rows a group a pass; kResidual: mode (b).
template <typename T, int G, int VPL, int R, bool kResidual>
__global__ void __launch_bounds__(kThreads)
nhwcLayerNormKernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ yBias,
                    const T* __restrict__ scale, const T* __restrict__ weight, const T* __restrict__ bias,
                    T* __restrict__ z, T* __restrict__ out, long long rows, int C, float eps) {
  using P = Pack<T>;
  constexpr int kN = P::kN;
  constexpr int kSlots = kThreads / G;  // rows a block serves at once
  const int nv = C / kN;                // vectors a row
  const int lane = threadIdx.x % G, slot = threadIdx.x / G;
  const float fc = (float)C;

  float w[VPL][kN], b[VPL][kN], yb[VPL][kN], sc[VPL][kN];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int v = lane + j * G;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const bool in = v < nv;
      w[j][i] = in ? P::scalar(weight, v * kN + i) : 0.0f;
      b[j][i] = in ? P::scalar(bias, v * kN + i) : 0.0f;
      if constexpr (kResidual) {
        yb[j][i] = in ? P::scalar(yBias, v * kN + i) : 0.0f;
        sc[j][i] = in ? P::scalar(scale, v * kN + i) : 0.0f;
      }
    }
  }

  const long long step = (long long)gridDim.x * kSlots * R;
  // the bound is the same for every lane of a warp: all take part in the shuffles
  for (long long base = (long long)blockIdx.x * kSlots * R; base < rows; base += step) {
    float v[R][VPL][kN];
    uint4 yu[kResidual ? R : 1][VPL];  // y's vectors, loaded beside x's
    long long row[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row[r] = base + r * kSlots + slot;
      ok[r] = row[r] < rows;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = lane + j * G;
        if (ok[r] && vi < nv) {
          P::unpack(*reinterpret_cast<const uint4*>(x + row[r] * C + vi * kN), v[r][j]);
          if constexpr (kResidual) yu[r][j] = *reinterpret_cast<const uint4*>(y + row[r] * C + vi * kN);
        } else {
#pragma unroll
          for (int i = 0; i < kN; ++i) v[r][j][i] = 0.0f;
        }
      }
    }
    if constexpr (kResidual) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int vi = lane + j * G;
          if (ok[r] && vi < nv) {
            float t[kN];
            P::unpack(yu[r][j], t);
#pragma unroll
            for (int i = 0; i < kN; ++i)
              v[r][j][i] = __fadd_rn(v[r][j][i], __fmul_rn(__fadd_rn(t[i], yb[j][i]), sc[j][i]));
            *reinterpret_cast<uint4*>(z + row[r] * C + vi * kN) = P::pack(v[r][j]);
#pragma unroll
            for (int i = 0; i < kN; ++i) v[r][j][i] = P::round(v[r][j][i]);  // n from the z written
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int i = 0; i < kN; ++i) s += v[r][j][i];  // zeros outside the row
      const float mean = __fdiv_rn(groupSum<G>(s), fc);
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (lane + j * G < nv) {
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            const float d = v[r][j][i] - mean;
            q = fmaf(d, d, q);
          }
        }
      }
      const float rstd = rsqrtf(__fdiv_rn(groupSum<G>(q), fc) + eps);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = lane + j * G;
        if (ok[r] && vi < nv) {
          float o[kN];
#pragma unroll
          for (int i = 0; i < kN; ++i) o[i] = fmaf((v[r][j][i] - mean) * rstd, w[j][i], b[j][i]);
          *reinterpret_cast<uint4*>(out + row[r] * C + vi * kN) = P::pack(o);
        }
      }
    }
  }
}

template <typename T, int G, int VPL, bool kResidual>
int launch(const void* x, const void* y, const void* yBias, const void* scale, const void* weight,
           const void* bias, void* z, void* out, long long rows, int C, float eps, int sms, cudaStream_t stream) {
  constexpr int R = VPL == 1 ? 2 : 1;
  const auto kernel = nhwcLayerNormKernel<T, G, VPL, R, kResidual>;
  static int resident = 0;  // blocks an SM holds at once, asked once an instance
  if (resident == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = n > 0 ? n : 1;
  }
  const long long perBlock = (long long)(kThreads / G) * R;
  long long blocks = (rows + perBlock - 1) / perBlock;
  if (blocks > (long long)sms * resident) blocks = (long long)sms * resident;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const T*)y, (const T*)yBias, (const T*)scale, (const T*)weight, (const T*)bias, (T*)z, (T*)out,
      rows, C, eps);
  return cudaGetLastError();
}

// The instance for C: G the row's vectors rounded up to a power of two (at
// least 4, at most 32), VPL the vectors a lane then holds, rounded up to a
// power of two.
template <typename T, bool kResidual>
int dispatch(const void* x, const void* y, const void* yBias, const void* scale, const void* weight,
             const void* bias, void* z, void* out, long long rows, int C, float eps, int sms, cudaStream_t s) {
  const int nv = C / Pack<T>::kN;
#define K8_LAUNCH(G, VPL) launch<T, G, VPL, kResidual>(x, y, yBias, scale, weight, bias, z, out, rows, C, eps, sms, s)
  if (nv <= 4) return K8_LAUNCH(4, 1);
  if (nv <= 8) return K8_LAUNCH(8, 1);
  if (nv <= 16) return K8_LAUNCH(16, 1);
  if (nv <= 32) return K8_LAUNCH(32, 1);
  if (nv <= 64) return K8_LAUNCH(32, 2);
  if (nv <= 128) return K8_LAUNCH(32, 4);
  if constexpr (Pack<T>::kN == 4) {  // fp32 at C > 512
    if (nv <= 256) return K8_LAUNCH(32, 8);
  }
#undef K8_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, for every tensor.  x (and y, z, out): rows x C,
// contiguous, 16-byte aligned; weight, bias (and yBias, scale): C values.
// y null: mode (a), n = LN(x) into out.  y set: mode (b), z = x + (y +
// yBias) * scale into z, n = LN(z) into out.  C a multiple of 8 in [32,
// 1024]; sms the card's multiprocessors.  Launches on stream, nothing when
// rows is 0; returns a cudaError_t.
int nhwcLayerNorm(int dtype, const void* x, const void* y, const void* yBias, const void* scale, const void* weight,
                  const void* bias, void* z, void* out, long long rows, int C, float eps, int sms, void* stream) {
  if (C < 32 || C > 1024 || C % 8 != 0 || rows < 0 || sms < 1 || x == nullptr || out == nullptr ||
      weight == nullptr || bias == nullptr || (y != nullptr && (yBias == nullptr || scale == nullptr || z == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return y == nullptr ? dispatch<float, false>(x, y, yBias, scale, weight, bias, z, out, rows, C, eps, sms, s)
                        : dispatch<float, true>(x, y, yBias, scale, weight, bias, z, out, rows, C, eps, sms, s);
  if (dtype == 1)
    return y == nullptr
               ? dispatch<__nv_bfloat16, false>(x, y, yBias, scale, weight, bias, z, out, rows, C, eps, sms, s)
               : dispatch<__nv_bfloat16, true>(x, y, yBias, scale, weight, bias, z, out, rows, C, eps, sms, s);
  return cudaErrorInvalidValue;
}

const char* layerNormErrorString(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
