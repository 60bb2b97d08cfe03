// K8 rmsnorm: y = x * rsqrt(mean(x^2) + eps) * w per row, in fp32, cast
// once to x's dtype.
//
// Replaces src/repro/kernels/rmsnorm/kernel.py: rmsnorm_2d
// (_rmsnorm_kernel).  Semantics kept: the row is widened to fp32, its
// mean square reduced in fp32, and the product (x * r) * w -- w widened to
// fp32 -- is rounded once to x's dtype, which is where the plain version
// (and the JAX reference) rounds.  x and w may each be fp32 or bf16
// (norm weights may be fp32 under a bf16 activation).
//
// Layout: rows of D contiguous elements at a row stride (one row per
// CTA).  Where the row base and stride allow it, the row is read as
// 16-byte vectors (4 fp32 or 8 bf16); the elements past the last whole
// vector (D not a multiple of the vector) and any misaligned row go
// through scalar loads.  The first pass sums squares (warp shuffles, then
// one shared-memory step across warps); the second pass reads the row
// again -- from L1/L2, it is at most a few KB -- scales and stores.
//
// Bound on the H100: bytes.  Each element of x is read once from device
// memory and written once, w (D elements) is read once per CTA but stays
// in L2: ~2 flop per byte, far below the ~20 flop/B where fp32 SIMT would
// bind.  No shared-memory staging and no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}

// A 16-byte vector as fp32 values and back (the element at the lower
// address sits in the low half of each 32-bit word).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) rmsnorm_rows(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
    int d, long long sx, long long so, int n_vec, float eps) {
  constexpr int VEC = Vec<TX>::n;
  const TX* xr = x + static_cast<long long>(blockIdx.x) * sx;
  TX* orow = out + static_cast<long long>(blockIdx.x) * so;
  const int tid = threadIdx.x;
  float ss = 0.f;
  for (int i = tid; i < n_vec; i += kThreads) {
    float f[VEC];
    Vec<TX>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
  for (int i = n_vec * VEC + tid; i < d; i += kThreads) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }
  __shared__ float part[kThreads / 32];
  ss = warp_sum(ss);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  if (tid < 32) {
    float t = tid < kThreads / 32 ? part[tid] : 0.f;
    t = warp_sum(t);
    if (tid == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / static_cast<float>(d) + eps);
  for (int i = tid; i < n_vec; i += kThreads) {
    float f[VEC];
    Vec<TX>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = (f[e] * r) * to_f32(w[i * VEC + e]);
    reinterpret_cast<uint4*>(orow)[i] = Vec<TX>::pack(f);
  }
  for (int i = n_vec * VEC + tid; i < d; i += kThreads)
    orow[i] = from_f32<TX>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d,
           long long sx, long long so, float eps, int vec,
           cudaStream_t stream) {
  const int n_vec = vec ? d / Vec<TX>::n : 0;
  rmsnorm_rows<TX, TW><<<rows, kThreads, 0, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, d, sx, so, n_vec, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x (rows, d) at row stride sx,
// out (rows, d) at row stride so, both in x_dtype with d contiguous; w (d,)
// contiguous in w_dtype.  vec = 1 when x, out and both row strides are
// 16-byte aligned (the wrapper checks), so rows may be read as vectors.
extern "C" int tardis_rmsnorm(const void* x, const void* w, void* out,
                              int rows, int d, long long sx, long long so,
                              float eps, int x_dtype, int w_dtype, int vec,
                              void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, out, rows, d, sx, so, eps, vec, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, rows, d, sx, so, eps, vec,
                                        s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, rows, d, sx, so, eps, vec,
                                        s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, sx, so,
                                                eps, vec, s);
  return (int)cudaErrorInvalidValue;
}
