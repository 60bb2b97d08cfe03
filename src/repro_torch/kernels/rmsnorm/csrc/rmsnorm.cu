// K8 rmsnorm: y = g * rsqrt(mean(g^2) + eps) * w per row, in fp32, cast
// once to the row's dtype, where g -- the row that is normed -- comes from
// one of three prologues:
//   plain  g = x                                  (rmsnorm_2d)
//   add    g = h = round(x + r), h also written    (the residual add)
//   gate   g = round(round(y) * round(silu(z)))   (Mamba2's gated norm)
//
// Replaces src/repro/kernels/rmsnorm/kernel.py: rmsnorm_2d
// (_rmsnorm_kernel).  Semantics kept: the row is widened to fp32, its
// mean square reduced in fp32, and the product (g * r) * w -- w widened to
// fp32 -- is rounded once to the row's dtype, which is where the plain
// version (and the JAX reference) rounds.  The prologues round where the
// eager code they replace rounds: the add is one fp32 add rounded once to
// x's dtype (torch.add's arithmetic, so h is the eager add bit for bit);
// the gate rounds the scan's fp32 y and the fp32 silu(z) to z's dtype and
// their product once more (src/repro/models/ssm.py: ssm_block).  The row
// dtype (x's; z's for the gate) and w's may each be fp32 or bf16; the
// gate's y is fp32.
//
// Layout: rows of D contiguous elements at a row stride (z is a column
// slice of in_proj's output, read where it lies).  One CTA per row, sized
// to it: a thread holds CHUNKS 16-byte chunks of the row (4 fp32 or 8
// bf16 values), packed in the row's dtype (g is exact in it: every
// prologue ends in that rounding), so the row is read ONCE from memory.
// The sum of squares is reduced by warp shuffles, then in one
// shared-memory step in which every warp sums all warps' parts in the
// same order; the registers are then scaled by w and stored.  Where a
// base or a row stride is not 16-byte aligned, and for the ragged last
// chunk of a row, the chunk moves through scalar loads and stores.  Many
// rows (a prefill) are bound by bytes: CHUNKS = 4 (a 2048-wide bf16 row
// takes 2 warps, 5120 takes 5) and w loaded after the reduction, which
// keeps registers low and more rows in flight.  A decode step's few rows
// are bound by latency: as few chunks a thread as a CTA allows (one at
// 2048: 8 warps a row) and w requested with the row (EARLY_W); each
// choice was timed both ways on the H100 (PERF.md, K8).
//
// Bound on the H100: bytes.  Each input element is read once from device
// memory and each output written once; w (D elements) stays in L1/L2.
// ~1-3 flop per byte, far below the ~20 flop/B where fp32 SIMT binds.  At
// decode's few rows the launch itself (~2.2 us) dominates: the fused
// prologues exist to remove the eager launches around the norm.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;  // a row of up to 2048 chunks
constexpr int kFewRows = 264;     // rows at most 2 an SM: the decode shape
enum Mode { kPlain = 0, kAdd = 1, kGate = 2 };

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
// x rounded to T (round to nearest even) and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// N values of T packed in 32-bit words as they lie in memory (bf16: the
// value at the lower address in the low half of a word).
template <typename T, int N> struct Pack {
  static constexpr int kWords = N * sizeof(T) / 4;
  unsigned u[kWords];

  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(u[e]);
    } else {
      const unsigned w = u[e >> 1];
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
  // f rounded to T (round to nearest even) into value e
  __device__ __forceinline__ void put(int e, float f) {
    if constexpr (sizeof(T) == 4) {
      u[e] = __float_as_uint(f);
    } else {
      const unsigned b = __bfloat16_as_ushort(__float2bfloat16(f));
      u[e >> 1] = (e & 1) ? ((u[e >> 1] & 0xffffu) | (b << 16))
                          : ((u[e >> 1] & 0xffff0000u) | b);
    }
  }
};

// N values of T at p: as 16- or 8-byte vectors where `vec`, else one by
// one, the values at and past `lim` as 0.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p, bool vec,
                                                int lim) {
  Pack<T, N> k;
  constexpr int kW = Pack<T, N>::kWords;
  if (vec) {
    if constexpr (kW % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kW / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        k.u[4 * i] = v.x;
        k.u[4 * i + 1] = v.y;
        k.u[4 * i + 2] = v.z;
        k.u[4 * i + 3] = v.w;
      }
    } else {
      static_assert(kW == 2, "8- or 16-byte vectors");
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      k.u[0] = v.x;
      k.u[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i) k.u[i] = 0u;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < lim) k.put(e, to_f32(p[e]));
  }
  return k;
}

// One 16-byte chunk of T to p, or its first `lim` values one by one.
template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, bool vec, int lim,
                                           const Pack<T, N>& k) {
  static_assert(N * sizeof(T) == 16, "one 16-byte chunk");
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(k.u[0], k.u[1], k.u[2], k.u[3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < lim) p[e] = from_f32<T>(k.get(e));
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TX: the row's dtype (x; z and the output for the gate); TW: w's.  a is
// x (plain, add) or the fp32 y (gate); b is r (add) or z (gate); h is the
// add's residual output.  Strides in elements.
template <typename TX, typename TW, int MODE, int CHUNKS, bool EARLY_W>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_rows(
    const void* __restrict__ a_, long long sa, const TX* __restrict__ b_,
    long long sb, const TW* __restrict__ w, TX* __restrict__ out,
    long long so, TX* __restrict__ h_, long long sh, int d, float eps,
    int vec) {
  using TA = std::conditional_t<MODE == kGate, float, TX>;
  constexpr int V = 16 / sizeof(TX);   // values in a chunk
  const long long row = blockIdx.x;
  const TA* a = static_cast<const TA*>(a_) + row * sa;
  const int tid = threadIdx.x, nt = blockDim.x;
  Pack<TX, V> g[CHUNKS] = {};
  Pack<TW, V> wp[CHUNKS];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = (tid + c * nt) * V;
    if (e0 >= d) continue;
    const int lim = d - e0;
    const bool full = vec && lim >= V;
    if constexpr (EARLY_W) wp[c] = load_pack<TW, V>(w + e0, full, lim);
    if constexpr (MODE == kPlain) {
      g[c] = load_pack<TX, V>(a + e0, full, lim);
    } else if constexpr (MODE == kAdd) {
      const Pack<TX, V> x = load_pack<TX, V>(a + e0, full, lim);
      const Pack<TX, V> r = load_pack<TX, V>(b_ + row * sb + e0, full, lim);
#pragma unroll
      for (int e = 0; e < V; ++e) g[c].put(e, x.get(e) + r.get(e));
      store_pack<TX, V>(h_ + row * sh + e0, full, lim, g[c]);
    } else {
      const Pack<float, V> y = load_pack<float, V>(a + e0, full, lim);
      const Pack<TX, V> z = load_pack<TX, V>(b_ + row * sb + e0, full, lim);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float zf = z.get(e);
        const float s = zf / (1.f + expf(-zf));   // silu in fp32
        g[c].put(e, round_to<TX>(y.get(e)) * round_to<TX>(s));
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) ss += g[c].get(e) * g[c].get(e);
  }
  ss = warp_sum(ss);
  if (nt > 32) {
    __shared__ float part[kMaxThreads / 32];
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < nt / 32; ++i) ss += part[i];
  }
  const float rs = rsqrtf(ss / static_cast<float>(d) + eps);
  TX* o = out + row * so;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = (tid + c * nt) * V;
    if (e0 >= d) continue;
    const int lim = d - e0;
    const bool full = vec && lim >= V;
    Pack<TW, V> wc;
    if constexpr (EARLY_W)
      wc = wp[c];
    else
      wc = load_pack<TW, V>(w + e0, full, lim);
    Pack<TX, V> y = {};
#pragma unroll
    for (int e = 0; e < V; ++e) y.put(e, (g[c].get(e) * rs) * wc.get(e));
    store_pack<TX, V>(o + e0, full, lim, y);
  }
}

template <typename TX, typename TW, int MODE, int CHUNKS, bool EARLY_W>
int launch_rows(const void* a, long long sa, const void* b, long long sb,
                const void* w, void* out, long long so, void* h,
                long long sh, int rows, int d, float eps, int vec,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int chunks = (d + V - 1) / V;
  const int threads = ((chunks + CHUNKS - 1) / CHUNKS + 31) / 32 * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  rmsnorm_rows<TX, TW, MODE, CHUNKS, EARLY_W><<<rows, threads, 0, stream>>>(
      a, sa, static_cast<const TX*>(b), sb, static_cast<const TW*>(w),
      static_cast<TX*>(out), so, static_cast<TX*>(h), sh, d, eps, vec);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, int MODE>
int launch_mode(const void* a, long long sa, const void* b, long long sb,
                const void* w, void* out, long long so, void* h,
                long long sh, int rows, int d, float eps, int vec,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int chunks = (d + V - 1) / V;
  // few rows (latency-bound): as few chunks a thread as a CTA allows, w
  // requested with the row; many rows (bytes-bound): 4 chunks a thread,
  // w after the reduction (fewer registers, more rows in flight)
  if (rows <= kFewRows && chunks <= kMaxThreads)
    return launch_rows<TX, TW, MODE, 1, true>(a, sa, b, sb, w, out, so, h,
                                              sh, rows, d, eps, vec, stream);
  if (rows <= kFewRows && chunks <= 2 * kMaxThreads)
    return launch_rows<TX, TW, MODE, 2, true>(a, sa, b, sb, w, out, so, h,
                                              sh, rows, d, eps, vec, stream);
  if (rows <= kFewRows)
    return launch_rows<TX, TW, MODE, 4, true>(a, sa, b, sb, w, out, so, h,
                                              sh, rows, d, eps, vec, stream);
  return launch_rows<TX, TW, MODE, 4, false>(a, sa, b, sb, w, out, so, h, sh,
                                             rows, d, eps, vec, stream);
}

template <typename TX, typename TW>
int launch(int mode, const void* a, long long sa, const void* b,
           long long sb, const void* w, void* out, long long so, void* h,
           long long sh, int rows, int d, float eps, int vec,
           cudaStream_t stream) {
  if (mode == kPlain)
    return launch_mode<TX, TW, kPlain>(a, sa, b, sb, w, out, so, h, sh, rows,
                                       d, eps, vec, stream);
  if (mode == kAdd)
    return launch_mode<TX, TW, kAdd>(a, sa, b, sb, w, out, so, h, sh, rows,
                                     d, eps, vec, stream);
  if (mode == kGate)
    return launch_mode<TX, TW, kGate>(a, sa, b, sb, w, out, so, h, sh, rows,
                                      d, eps, vec, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 plain, 1 add, 2 gate.  dtype codes: 0 = float32, 1 = bfloat16;
// x_dtype is the row's (x; z and the output for the gate), w_dtype w's.
// a: x (rows, d) at row stride sa, or the gate's fp32 y; b: the add's r or
// the gate's z (rows, d) at row stride sb (unused by plain); w (d,)
// contiguous; out (rows, d) at row stride so; h: the add's residual
// output (rows, d) at row stride sh.  Strides in elements, the last dim
// contiguous.  vec = 1 when every base and row stride is 16-byte aligned
// (the wrapper checks), so whole chunks move as vectors.  Rows up to
// 2048 16-byte chunks (16384 bf16 or 8192 fp32 values).
extern "C" int tardis_rmsnorm(int mode, const void* a, long long sa,
                              const void* b, long long sb, const void* w,
                              void* out, long long so, void* h, long long sh,
                              int rows, int d, float eps, int x_dtype,
                              int w_dtype, int vec, void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(mode, a, sa, b, sb, w, out, so, h, sh, rows,
                                d, eps, vec, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(mode, a, sa, b, sb, w, out, so, h,
                                        sh, rows, d, eps, vec, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(mode, a, sa, b, sb, w, out, so, h,
                                        sh, rows, d, eps, vec, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(mode, a, sa, b, sb, w, out,
                                                so, h, sh, rows, d, eps, vec,
                                                s);
  return (int)cudaErrorInvalidValue;
}
