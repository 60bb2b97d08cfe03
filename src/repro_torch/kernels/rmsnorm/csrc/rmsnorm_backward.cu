// K11 rmsnorm_backward: the gradient of K8's plain and add variants.
//
// Forward (K8): y = g * rstd * w per row, rstd = rsqrt(mean(g^2) + eps),
// in fp32, rounded once to the row's dtype; g = x (plain) or g = h =
// round(x + r) (add, h also an output).  Backward, per row in fp32:
//   xhat = g * rstd,  gw = dy * w,  c = mean(gw * xhat),
//   dg   = rstd * (gw - xhat * c)            (+ dh: the add variant's h
//                                             gradient, dx = dr = dh + dg)
// and over all rows dw = sum_rows dy * xhat.  dx is written in the row's
// dtype and dw in w's.  There is no TPU backward to replace: the JAX
// package differentiates src/repro/kernels/rmsnorm/ref.py's plain norm
// with autodiff; this is that closed form.
//
// Layout: g, dy, dh and dx are rows of D contiguous elements at their own
// row strides; w is (D,).  Kernel 1 (rmsnorm_bwd_rows): a grid of n_ctas
// CTAs (the wrapper's BWD_CTAS = 264, fewer for fewer rows), sized to the
// row (a thread holds kVpt columns j = t + k * blockDim, so the loads are
// coalesced); CTA c takes rows c, c +
// gridDim, ... in order, one row at a time: the row's two sums
// (sum g^2 and sum gw * g) are reduced by warp shuffles and one
// shared-memory step in which every thread adds the warps' parts in the
// same order, then dx is written, and the thread adds dy * xhat into its
// columns' fp32 partials of dw.  Each CTA writes its partial row of dw
// (gridDim x D fp32); kernel 2 (rmsnorm_bwd_dw) sums those partials over
// the CTAs in CTA order, a thread a column.  No float atomics: the order
// of every sum is fixed by the shapes alone, so two calls are bit
// identical.
//
// Bound on the H100: bytes.  g, dy (and dh) are read once and dx written
// once; w and the partials (n_ctas x D fp32, 2 MB at D = 2048) stay in
// L2.  ~10 flop per element, far below what would bind fp32 SIMT.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVpt = 8;          // columns a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt(float x) {
  return __float2bfloat16(x);
}

// (sum a, sum b) over the CTA; every thread gets the same bits (the warp
// butterfly is symmetric, and every thread adds the warps' parts in warp
// order).
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    s.x += red[i].x;
    s.y += red[i].y;
  }
  __syncthreads();  // red is written again by the next row
  return s;
}

template <typename T, typename W>
__global__ void rmsnorm_bwd_rows(const T* __restrict__ g, long long sg,
                                 const T* __restrict__ dy, long long sdy,
                                 const T* __restrict__ dh, long long sdh,
                                 const W* __restrict__ w, T* __restrict__ dx,
                                 long long sdx, float* __restrict__ partial,
                                 int rows, int d, float eps) {
  __shared__ float2 red[kMaxWarps];
  const int t = threadIdx.x, nt = blockDim.x;
  float wv[kVpt], acc[kVpt];
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int j = t + k * nt;
    wv[k] = j < d ? ldf(w + j) : 0.f;
    acc[k] = 0.f;
  }
  const float inv_d = 1.f / (float)d;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* gr = g + (long long)r * sg;
    const T* dyr = dy + (long long)r * sdy;
    float gv[kVpt], dyv[kVpt], dhv[kVpt];
    float ss = 0.f, sgw = 0.f;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {  // dh too is requested before the sums
      const int j = t + k * nt;
      gv[k] = j < d ? ldf(gr + j) : 0.f;
      dyv[k] = j < d ? ldf(dyr + j) : 0.f;
      dhv[k] = (dh != nullptr && j < d) ? ldf(dh + (long long)r * sdh + j)
                                        : 0.f;
      ss += gv[k] * gv[k];
      sgw += dyv[k] * wv[k] * gv[k];
    }
    const float2 s = block_sum2(ss, sgw, red);
    const float rstd = rsqrtf(s.x * inv_d + eps);
    const float c = rstd * s.y * inv_d;          // mean(gw * xhat)
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int j = t + k * nt;
      if (j < d) {
        const float xh = gv[k] * rstd;
        const float v = rstd * (dyv[k] * wv[k] - xh * c) + dhv[k];
        dx[(long long)r * sdx + j] = cvt<T>(v);
        acc[k] += dyv[k] * xh;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int j = t + k * nt;
    if (j < d) partial[(long long)blockIdx.x * d + j] = acc[k];
  }
}

template <typename W>
__global__ void rmsnorm_bwd_dw(const float* __restrict__ partial, int n,
                               int d, W* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += partial[(long long)i * d + j];
  dw[j] = cvt<W>(s);
}

template <typename T, typename W>
int launch(const void* g, long long sg, const void* dy, long long sdy,
           const void* dh, long long sdh, const void* w, void* dx,
           long long sdx, void* partial, void* dw, int rows, int d,
           int n_ctas, float eps, cudaStream_t s) {
  int nt = (d + kVpt - 1) / kVpt;
  nt = (nt + 31) / 32 * 32;
  if (nt > kMaxThreads) return (int)cudaErrorInvalidValue;
  rmsnorm_bwd_rows<T, W><<<n_ctas, nt, 0, s>>>(
      (const T*)g, sg, (const T*)dy, sdy, (const T*)dh, sdh, (const W*)w,
      (T*)dx, sdx, (float*)partial, rows, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw<W><<<(d + 255) / 256, 256, 0, s>>>((const float*)partial,
                                                     n_ctas, d, (W*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// dh may be NULL (the plain variant, or an add whose h has no gradient);
// partial is n_ctas x d fp32 scratch; n_ctas <= rows.
extern "C" int tardis_rmsnorm_backward(
    const void* g, long long sg, const void* dy, long long sdy,
    const void* dh, long long sdh, const void* w, void* dx, long long sdx,
    void* partial, void* dw, int rows, int d, int n_ctas, float eps,
    int x_dtype, int w_dtype, void* stream) {
  if (d <= 0 || n_ctas <= 0 || n_ctas > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(g, sg, dy, sdy, dh, sdh, w, dx, sdx, partial,
                                dw, rows, d, n_ctas, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                        partial, dw, rows, d, n_ctas, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                        partial, dw, rows, d, n_ctas, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(g, sg, dy, sdy, dh, sdh, w,
                                                dx, sdx, partial, dw, rows, d,
                                                n_ctas, eps, s);
  return (int)cudaErrorInvalidValue;
}
