// K11 rmsnorm_backward: the gradient of K8's plain, add and gate variants.
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
// Bound on the H100: bytes.  g, dy (and dh) are read once and dx written
// once; w and the dw partials stay in L2.  ~10 flop per element, far below
// what would bind fp32 SIMT.  So the design keeps HBM busy:
//  * Kernel 1 (rmsnorm_bwd_rows): a CTA of nt = 32 * ceil(D / 256)
//    threads holds a row, 8 columns a thread -- two 16-byte vectors of
//    fp32 or one of bf16 where every row and pointer is 16-byte aligned
//    (else 8 scalars at j = t + k * nt), so loads and stores are 16 bytes
//    a thread and coalesced.  Its CTAs take rows c, c + gridDim, ... and
//    keep the NEXT row's loads in flight (a register double buffer) while
//    the current row reduces and writes.  The row's two sums (g^2 and
//    gw * g) are warp butterflies (symmetric: every lane gets the same
//    bits); a row of one warp (D <= 256) needs nothing more, a wider one
//    one barrier a row (the warps' parts in a shared buffer that
//    alternates between rows, added in warp order by every thread).
//  * Each thread adds dy * xhat into its columns' fp32 partials of dw and
//    writes them once (gridDim x D fp32).  Kernel 2 (rmsnorm_bwd_dw)
//    spreads their sum over the card: a CTA takes 32 columns, its 32
//    warps each sum every 32nd partial row in order, and a fixed tree over
//    the warps finishes each column.
// No float atomics: the order of every sum is fixed by the shapes, the
// strides' alignment and the CTA count (the wrapper's, from D alone), so
// two calls are bit identical.
//
// The gate variant (rmsnorm_bwd_rows_gate): K8's gate normed
// u = round(round(y) * round(silu(z))) -- y the scan's fp32 output, z
// the gate in the row's dtype T (a column slice of in_proj's output, read
// at its row stride) -- so the row is recomputed from y and z in fp32,
// rounded where K8 rounds, and its du is dg above with g = u.  Then, with
// sig = sigmoid(z) and silu'(z) = sig (1 + z (1 - sig)):
//   dy = du * round(silu(z))  (fp32, y's gradient),
//   dz = du * round(y) * silu'(z)  (in T),
// and dw's partials as above (the same second kernel sums them).  Each
// row reads y, z and the output's gradient once and writes dy and dz
// once: bytes again.  One row a CTA pass (no next-row prefetch: the row's
// five streams already keep a CTA's loads in flight).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kElems = 8;         // columns a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kDwCols = 32;       // kernel 2: columns of a CTA
constexpr int kDwSlices = 32;     // kernel 2: its warps, a partial row each

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt(float x) {
  return __float2bfloat16(x);
}

// V elements of T as one load: a 16-byte vector (V = 16 / sizeof(T)) or a
// scalar (V = 1); R is what a load returns
template <typename T, int V> struct Pack;
template <> struct Pack<float, 4> {
  using R = uint4;
  __device__ static void unpack(const R& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static R pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Pack<__nv_bfloat16, 8> {
  using R = uint4;
  __device__ static void unpack2(unsigned u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
  __device__ static unsigned pack2(float lo, float hi) {
    const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
    return l | (h << 16);
  }
  __device__ static void unpack(const R& r, float (&f)[8]) {
    unpack2(r.x, f[0], f[1]); unpack2(r.y, f[2], f[3]);
    unpack2(r.z, f[4], f[5]); unpack2(r.w, f[6], f[7]);
  }
  __device__ static R pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};
template <typename T> struct Pack<T, 1> {
  using R = T;
  __device__ static void unpack(const R& r, float (&f)[1]) { f[0] = ldf(&r); }
  __device__ static R pack(const float (&f)[1]) { return cvt<T>(f[0]); }
};

template <typename T, int V>
__device__ __forceinline__ typename Pack<T, V>::R ldv(const T* p) {
  return *reinterpret_cast<const typename Pack<T, V>::R*>(p);
}

// row r's kN vectors of this thread (vector jv = t + k * nt, element
// jv * V + u; a scalar row V = 1 so the loads are coalesced either way)
template <typename T, int V, int kN>
__device__ __forceinline__ void load_row(const T* base, long long stride,
                                         int r, int t, int nt, int dv,
                                         typename Pack<T, V>::R (&out)[kN]) {
  const T* row = base + static_cast<long long>(r) * stride;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int jv = t + k * nt;
    out[k] = jv < dv ? ldv<T, V>(row + jv * V) : typename Pack<T, V>::R{};
  }
}

template <typename T, typename W, int V, int kMaxT>
__global__ void __launch_bounds__(kMaxT, kMaxT <= 256 ? 2 : 1)
    rmsnorm_bwd_rows(const T* __restrict__ g, long long sg,
                     const T* __restrict__ dy, long long sdy,
                     const T* __restrict__ dh, long long sdh,
                     const W* __restrict__ w, T* __restrict__ dx,
                     long long sdx, float* __restrict__ partial, int rows,
                     int d, float eps) {
  using P = Pack<T, V>;
  using R = typename P::R;
  constexpr int kN = kElems / V;      // vectors a thread holds
  __shared__ float2 red[2][kMaxThreads / 32];
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31, n_warps = nt >> 5;
  const int dv = d / V;
  const bool has_dh = dh != nullptr;
  float wv[kN][V], acc[kN][V];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int jv = t + k * nt;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      wv[k][u] = jv < dv ? ldf(w + jv * V + u) : 0.f;
      acc[k][u] = 0.f;
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  R cg[kN], cdy[kN], cdh[kN], ng[kN], ndy[kN], ndh[kN];
  int r = blockIdx.x;
  if (r < rows) {
    load_row<T, V, kN>(g, sg, r, t, nt, dv, cg);
    load_row<T, V, kN>(dy, sdy, r, t, nt, dv, cdy);
    if (has_dh) load_row<T, V, kN>(dh, sdh, r, t, nt, dv, cdh);
  }
  int par = 0;
  for (; r < rows; r += gridDim.x) {
    // the next row's loads go out before this row reduces
    const int rn = r + gridDim.x;
    if (rn < rows) {
      load_row<T, V, kN>(g, sg, rn, t, nt, dv, ng);
      load_row<T, V, kN>(dy, sdy, rn, t, nt, dv, ndy);
      if (has_dh) load_row<T, V, kN>(dh, sdh, rn, t, nt, dv, ndh);
    }
    float gv[kN][V], dyv[kN][V];
    float ss = 0.f, sgw = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      P::unpack(cg[k], gv[k]);
      P::unpack(cdy[k], dyv[k]);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        ss += gv[k][u] * gv[k][u];
        sgw += dyv[k][u] * wv[k][u] * gv[k][u];
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgw += __shfl_xor_sync(0xffffffffu, sgw, o);
    }
    if (n_warps > 1) {
      if (lane == 0) red[par][warp] = make_float2(ss, sgw);
      __syncthreads();
      ss = sgw = 0.f;
      for (int i = 0; i < n_warps; ++i) {
        ss += red[par][i].x;
        sgw += red[par][i].y;
      }
      par ^= 1;         // the next row writes the other buffer
    }
    const float rstd = rsqrtf(ss * inv_d + eps);
    const float c = rstd * sgw * inv_d;          // mean(gw * xhat)
    T* const dxr = dx + static_cast<long long>(r) * sdx;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int jv = t + k * nt;
      if (jv < dv) {
        float dhv[V], out[V];
        if (has_dh) P::unpack(cdh[k], dhv);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xh = gv[k][u] * rstd;
          out[u] = rstd * (dyv[k][u] * wv[k][u] - xh * c)
                 + (has_dh ? dhv[u] : 0.f);
          acc[k][u] += dyv[k][u] * xh;
        }
        *reinterpret_cast<R*>(dxr + jv * V) = P::pack(out);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      cg[k] = ng[k];
      cdy[k] = ndy[k];
      cdh[k] = ndh[k];
    }
  }
  float* const pr = partial + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int jv = t + k * nt;
    if (jv < dv) {
#pragma unroll
      for (int u = 0; u < V; ++u) pr[jv * V + u] = acc[k][u];
    }
  }
}

// V fp32 values from p (a 16-byte vector a 4, or a scalar)
template <int V>
__device__ __forceinline__ void ld_f32(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = q.x; f[4 * i + 1] = q.y; f[4 * i + 2] = q.z;
      f[4 * i + 3] = q.w;
    }
  }
}
template <int V>
__device__ __forceinline__ void st_f32(float* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  const T v = cvt<T>(x);
  return ldf(&v);
}

template <typename T, typename W, int V, int kMaxT>
__global__ void __launch_bounds__(kMaxT, kMaxT <= 256 ? 2 : 1)
    rmsnorm_bwd_rows_gate(const float* __restrict__ y, long long sy,
                          const T* __restrict__ z, long long sz,
                          const T* __restrict__ dout, long long sdo,
                          const W* __restrict__ w, float* __restrict__ dyo,
                          long long sdyo, T* __restrict__ dz, long long sdz,
                          float* __restrict__ partial, int rows, int d,
                          float eps) {
  using P = Pack<T, V>;
  constexpr int kN = kElems / V;      // vectors a thread holds
  __shared__ float2 red[2][kMaxThreads / 32];
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31, n_warps = nt >> 5;
  const int dv = d / V;
  float wv[kN][V], acc[kN][V];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int jv = t + k * nt;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      wv[k][u] = jv < dv ? ldf(w + jv * V + u) : 0.f;
      acc[k][u] = 0.f;
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  int par = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* yr = y + static_cast<long long>(r) * sy;
    const T* zr = z + static_cast<long long>(r) * sz;
    const T* dr = dout + static_cast<long long>(r) * sdo;
    float yv[kN][V], zv[kN][V], dov[kN][V], uv[kN][V], slv[kN][V];
    float ss = 0.f, sgw = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int jv = t + k * nt;
      if (jv < dv) {
        ld_f32<V>(yr + jv * V, yv[k]);
        P::unpack(ldv<T, V>(zr + jv * V), zv[k]);
        P::unpack(ldv<T, V>(dr + jv * V), dov[k]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) yv[k][u] = zv[k][u] = dov[k][u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float zf = zv[k][u];
        slv[k][u] = round_to<T>(zf / (1.f + expf(-zf)));   // silu, as K8
        yv[k][u] = round_to<T>(yv[k][u]);
        uv[k][u] = round_to<T>(yv[k][u] * slv[k][u]);
        ss += uv[k][u] * uv[k][u];
        sgw += dov[k][u] * wv[k][u] * uv[k][u];
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgw += __shfl_xor_sync(0xffffffffu, sgw, o);
    }
    if (n_warps > 1) {
      if (lane == 0) red[par][warp] = make_float2(ss, sgw);
      __syncthreads();
      ss = sgw = 0.f;
      for (int i = 0; i < n_warps; ++i) {
        ss += red[par][i].x;
        sgw += red[par][i].y;
      }
      par ^= 1;         // the next row writes the other buffer
    }
    const float rstd = rsqrtf(ss * inv_d + eps);
    const float c = rstd * sgw * inv_d;          // mean(gw * xhat)
    float* const dyr = dyo + static_cast<long long>(r) * sdyo;
    T* const dzr = dz + static_cast<long long>(r) * sdz;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int jv = t + k * nt;
      if (jv < dv) {
        float gy[V], gz[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xh = uv[k][u] * rstd;
          const float du = rstd * (dov[k][u] * wv[k][u] - xh * c);
          const float zf = zv[k][u];
          const float sig = 1.f / (1.f + expf(-zf));
          gy[u] = du * slv[k][u];
          gz[u] = du * yv[k][u] * (sig * (1.f + zf * (1.f - sig)));
          acc[k][u] += dov[k][u] * xh;
        }
        st_f32<V>(dyr + jv * V, gy);
        *reinterpret_cast<typename P::R*>(dzr + jv * V) = P::pack(gz);
      }
    }
  }
  float* const pr = partial + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int jv = t + k * nt;
    if (jv < dv) {
#pragma unroll
      for (int u = 0; u < V; ++u) pr[jv * V + u] = acc[k][u];
    }
  }
}

// dw[j] = the sum over the n partial rows of column j: warp s of a CTA
// sums rows s, s + 32, ... in order, then a fixed tree over the warps
template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwSlices)
    rmsnorm_bwd_dw(const float* __restrict__ partial, int n, int d,
                   W* __restrict__ dw) {
  __shared__ float red[kDwSlices][kDwCols + 1];
  const int c = threadIdx.x % kDwCols, s = threadIdx.x / kDwCols;
  const int j = blockIdx.x * kDwCols + c;
  float v = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int i = s; i < n; i += kDwSlices)
      v += partial[static_cast<long long>(i) * d + j];
  }
  red[s][c] = v;
  __syncthreads();
#pragma unroll
  for (int h = kDwSlices / 2; h; h >>= 1) {
    if (s < h) red[s][c] += red[s + h][c];
    __syncthreads();
  }
  if (s == 0 && j < d) dw[j] = cvt<W>(red[0][c]);
}

template <typename T, typename W, int V, int kMaxT>
int launch_rows(const void* g, long long sg, const void* dy, long long sdy,
                const void* dh, long long sdh, const void* w, void* dx,
                long long sdx, void* partial, int rows, int d, int n_ctas,
                int nt, float eps, cudaStream_t s) {
  rmsnorm_bwd_rows<T, W, V, kMaxT><<<n_ctas, nt, 0, s>>>(
      (const T*)g, sg, (const T*)dy, sdy, (const T*)dh, sdh, (const W*)w,
      (T*)dx, sdx, (float*)partial, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* g, long long sg, const void* dy, long long sdy,
           const void* dh, long long sdh, const void* w, void* dx,
           long long sdx, void* partial, void* dw, int rows, int d,
           int n_ctas, float eps, int vec, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const int nt = (d + 32 * kElems - 1) / (32 * kElems) * 32;
  if (nt > kMaxThreads || (vec && d % kV != 0))
    return (int)cudaErrorInvalidValue;
  int e;
  if (vec)
    e = nt <= 256
        ? launch_rows<T, W, kV, 256>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                     partial, rows, d, n_ctas, nt, eps, s)
        : launch_rows<T, W, kV, kMaxThreads>(g, sg, dy, sdy, dh, sdh, w, dx,
                                             sdx, partial, rows, d, n_ctas,
                                             nt, eps, s);
  else
    e = nt <= 256
        ? launch_rows<T, W, 1, 256>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                    partial, rows, d, n_ctas, nt, eps, s)
        : launch_rows<T, W, 1, kMaxThreads>(g, sg, dy, sdy, dh, sdh, w, dx,
                                            sdx, partial, rows, d, n_ctas,
                                            nt, eps, s);
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_dw<W><<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0,
                      s>>>((const float*)partial, n_ctas, d, (W*)dw);
  return (int)cudaGetLastError();
}

template <typename T, typename W, int V, int kMaxT>
int launch_gate_rows(const void* y, long long sy, const void* z,
                     long long sz, const void* dout, long long sdo,
                     const void* w, void* dyo, long long sdyo, void* dz,
                     long long sdz, void* partial, int rows, int d,
                     int n_ctas, int nt, float eps, cudaStream_t s) {
  rmsnorm_bwd_rows_gate<T, W, V, kMaxT><<<n_ctas, nt, 0, s>>>(
      (const float*)y, sy, (const T*)z, sz, (const T*)dout, sdo,
      (const W*)w, (float*)dyo, sdyo, (T*)dz, sdz, (float*)partial, rows, d,
      eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_gate(const void* y, long long sy, const void* z, long long sz,
                const void* dout, long long sdo, const void* w, void* dyo,
                long long sdyo, void* dz, long long sdz, void* partial,
                void* dw, int rows, int d, int n_ctas, float eps, int vec,
                cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const int nt = (d + 32 * kElems - 1) / (32 * kElems) * 32;
  if (nt > kMaxThreads || (vec && d % kV != 0))
    return (int)cudaErrorInvalidValue;
  int e;
#define K11_GATE(V, MT)                                                      \
  launch_gate_rows<T, W, V, MT>(y, sy, z, sz, dout, sdo, w, dyo, sdyo, dz,   \
                                sdz, partial, rows, d, n_ctas, nt, eps, s)
  if (vec)
    e = nt <= 256 ? K11_GATE(kV, 256) : K11_GATE(kV, kMaxThreads);
  else
    e = nt <= 256 ? K11_GATE(1, 256) : K11_GATE(1, kMaxThreads);
#undef K11_GATE
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_dw<W><<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0,
                      s>>>((const float*)partial, n_ctas, d, (W*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// dh may be NULL (the plain variant, or an add whose h has no gradient);
// partial is n_ctas x d fp32 scratch; n_ctas <= rows; vec: every row of g,
// dy, dh and dx and their bases 16-byte aligned and d a multiple of a
// 16-byte vector (the wrapper checks).
extern "C" int tardis_rmsnorm_backward(
    const void* g, long long sg, const void* dy, long long sdy,
    const void* dh, long long sdh, const void* w, void* dx, long long sdx,
    void* partial, void* dw, int rows, int d, int n_ctas, float eps,
    int x_dtype, int w_dtype, int vec, void* stream) {
  if (d <= 0 || n_ctas <= 0 || n_ctas > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(g, sg, dy, sdy, dh, sdh, w, dx, sdx, partial,
                                dw, rows, d, n_ctas, eps, vec, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                        partial, dw, rows, d, n_ctas, eps,
                                        vec, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(g, sg, dy, sdy, dh, sdh, w, dx, sdx,
                                        partial, dw, rows, d, n_ctas, eps,
                                        vec, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(g, sg, dy, sdy, dh, sdh, w,
                                                dx, sdx, partial, dw, rows, d,
                                                n_ctas, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The gate variant: y (rows, d) fp32 at row stride sy; z and dout (the
// norm's output gradient) in the row dtype at sz / sdo; outputs dyo
// (fp32, y's gradient) at sdyo and dz (row dtype) at sdz; partial and dw
// as above; vec: every row and base of y, z, dout, dyo and dz 16-byte
// aligned and d a multiple of the row dtype's 16-byte vector.
extern "C" int tardis_rmsnorm_backward_gate(
    const void* y, long long sy, const void* z, long long sz,
    const void* dout, long long sdo, const void* w, void* dyo,
    long long sdyo, void* dz, long long sdz, void* partial, void* dw,
    int rows, int d, int n_ctas, float eps, int x_dtype, int w_dtype,
    int vec, void* stream) {
  if (d <= 0 || n_ctas <= 0 || n_ctas > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K11_GATE_TYPES(T, W)                                                \
  return launch_gate<T, W>(y, sy, z, sz, dout, sdo, w, dyo, sdyo, dz, sdz,  \
                           partial, dw, rows, d, n_ctas, eps, vec, s)
  if (x_dtype == 0 && w_dtype == 0) K11_GATE_TYPES(float, float);
  if (x_dtype == 0 && w_dtype == 1) K11_GATE_TYPES(float, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) K11_GATE_TYPES(__nv_bfloat16, float);
  if (x_dtype == 1 && w_dtype == 1)
    K11_GATE_TYPES(__nv_bfloat16, __nv_bfloat16);
#undef K11_GATE_TYPES
  return (int)cudaErrorInvalidValue;
}
