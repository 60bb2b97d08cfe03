// K7 ssd_chunk: the Mamba2 SSD intra-chunk term and chunk states.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py: ssd_intra_chunk
// (_ssd_kernel).  Per (batch b, chunk c, head h), with xdt_j = x_j * dt_j
// and cum the within-chunk cumulative log-decay:
//   y_intra[i, p] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * xdt_j[p]
//   S[p, n]       = sum_j B_j[n] * (exp(cum_last - cum_j) * xdt_j[p])
// in fp32, products formed in the plain version's order.  The exponential
// is evaluated only where i >= j: cum falls along the chunk, so for j > i
// exp(cum_i - cum_j) can overflow, and inf * 0 would be NaN.  The
// inter-chunk recurrence stays in PyTorch (ops.py), as the JAX ops.py kept
// it in jnp.
//
// Layout: x (b, s, h, p), B and C (b, s, [h,] n) and dt (b, s, h) are read
// where the model keeps them -- x, B and C are column slices of the conv
// output, at its token stride -- with p / n contiguous.  B and C carry a
// head stride that is 0 on the model path (one group shared by all heads):
// no broadcast copy, as the JAX ops.py made.  Positions t >= s (the chunk
// padding) read as 0.  cum (b, nc, q, h) comes from the wrapper.  Outputs
// y_intra (b, nc, q, h, p) and S (b, nc, h, p, n), fp32, contiguous.
//
// Grid: (b * nc, ceil(q / 64) + 1, ceil(h / heads_per_cta)).  CTA y < the
// last computes 64 rows i of y_intra: first C_i . B_j for its rows and every
// j <= its last row, once, into shared memory (shared by its heads when the
// head stride is 0), then per head and 64-wide slice of p, per 64-position
// j tile: the decay-weighted M = cb * exp(cum_i - cum_j) (built in shared
// memory, never in device memory -- the plain version writes L and M at
// (b, nc, q, q, h) fp32, ~1 GB each per zamba2 layer) and the product
// M . xdt, 4 x 4 outputs per thread.  The last CTA row computes the chunk
// states S for its heads.
//
// Bound on the H100: operations.  Per (chunk, head): ~q^2 (p + n) / 2 +
// q p n multiply-adds over ~q (p + 2n) * 4 bytes: ~100 flop per byte at
// q = 256, p = n = 64, so fp32 SIMT at 67 TFLOP/s binds before memory; no
// TF32 (the fp32 tolerance is 2e-4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each
constexpr int kT = 64;         // tile edge: rows i, positions j, p, n
constexpr int kHeadsPerCta = 8;
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const TX* __restrict__ x, long long xsb, long long xst, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dst,
    const float* __restrict__ cum, const TBC* __restrict__ B,
    const TBC* __restrict__ C, long long bsb, long long bst, long long bsh,
    int s, int nc, int q, int h, int p, int n, int heads_per_cta,
    float* __restrict__ y, float* __restrict__ S) {
  const int bc = blockIdx.x;
  const int bi = bc / nc, c = bc - bi * nc;
  const int h0 = blockIdx.z * heads_per_cta;
  const int h1 = min(h, h0 + heads_per_cta);
  const long long t_base = static_cast<long long>(c) * q;
  const int n_iblk = (q + kT - 1) / kT;
  const int q_r = n_iblk * kT;

  extern __shared__ float smem[];
  float* cumj = smem;               // q_r
  float* cbs = cumj + q_r;          // q_r x kT: cb[i][j] stored as [j][i]
  float* work = cbs + q_r * kT;     // phase A: Cs, Bs; phase B: Ms, Xs
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // position t of the chunk -> its (b, t) offsets, or -1 past s
  auto x_at = [&](int j, int hh, int pp) -> float {
    const long long t = t_base + j;
    if (j >= q || t >= s || pp >= p) return 0.f;
    return to_f32(x[bi * xsb + t * xst + hh * xsh + pp]) *
           dt[bi * dsb + t * dst + hh];
  };
  auto bc_at = [&](const TBC* m, int j, int hh, int nn) -> float {
    const long long t = t_base + j;
    if (j >= q || t >= s || nn >= n) return 0.f;
    return to_f32(m[bi * bsb + t * bst + hh * bsh + nn]);
  };
  const float* cum_bc = cum + static_cast<long long>(bc) * q * h;

  if (blockIdx.y == n_iblk) {
    // ---- chunk states S[p, n] for heads h0..h1 -------------------------
    float* xw = work;              // kT x kT: [j][p]
    float* bt = work + kT * kT;    // kT x kT: [j][n]
    for (int hh = h0; hh < h1; ++hh) {
      __syncthreads();
      for (int j = tid; j < q; j += kThreads) cumj[j] = cum_bc[j * h + hh];
      __syncthreads();
      const float cum_last = cumj[q - 1];
      for (int p0 = 0; p0 < p; p0 += kT) {
        for (int n0 = 0; n0 < n; n0 += kT) {
          float acc[4][4] = {};
          for (int j0 = 0; j0 < q; j0 += kT) {
            __syncthreads();
            for (int e = tid; e < kT * kT; e += kThreads) {
              const int jj = e / kT, cc = e - jj * kT;
              const int j = j0 + jj;
              const float w = j < q ? expf(cum_last - cumj[j]) : 0.f;
              xw[e] = w * x_at(j, hh, p0 + cc);
              bt[e] = bc_at(B, j, hh, n0 + cc);
            }
            __syncthreads();
            for (int jj = 0; jj < kT; ++jj) {
              const float4 a = *reinterpret_cast<const float4*>(
                  xw + jj * kT + ty * 4);
              const float4 bb = *reinterpret_cast<const float4*>(
                  bt + jj * kT + tx * 4);
              const float av[4] = {a.x, a.y, a.z, a.w};
              const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
            }
          }
          float* sh = S + (static_cast<long long>(bc) * h + hh) * p * n;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int pp = p0 + ty * 4 + u;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int nn = n0 + tx * 4 + v;
              if (pp < p && nn < n) sh[static_cast<long long>(pp) * n + nn] =
                  acc[u][v];
            }
          }
        }
      }
    }
    return;
  }

  // ---- y_intra rows i0 .. i0 + 63 ---------------------------------------
  const int i0 = blockIdx.y * kT;
  const int jmax = min(q, i0 + kT);        // causal: j <= i < i0 + 64
  const int ldn = n + 1;
  {
    // phase A: cb[i][j] = C_i . B_j for i in the block, j < jmax
    float* cs = work;                      // kT x ldn: [i][n]
    float* bs = work + kT * ldn;           // kT x ldn: [j][n]
    for (int e = tid; e < kT * n; e += kThreads) {
      const int r = e / n, nn = e - r * n;
      cs[r * ldn + nn] = bc_at(C, i0 + r, h0, nn);
    }
    for (int j0 = 0; j0 < jmax; j0 += kT) {
      __syncthreads();
      for (int e = tid; e < kT * n; e += kThreads) {
        const int r = e / n, nn = e - r * n;
        bs[r * ldn + nn] = bc_at(B, j0 + r, h0, nn);
      }
      __syncthreads();
      float acc[4][4] = {};               // [i = tx*4+u][j = ty*4+v]
      for (int nn = 0; nn < n; ++nn) {
        float a[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = cs[(tx * 4 + u) * ldn + nn];
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = bs[(ty * 4 + v) * ldn + nn];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * bv[v];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<float4*>(cbs + (j0 + ty * 4 + v) * kT + tx * 4) =
            make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
    }
  }

  // phase B: per head, y[i, p] = sum_j (cb[i][j] * exp(cum_i - cum_j)) xdt_j
  float* ms = work;                        // kT x kT: [j][i]
  float* xs = work + kT * kT;              // kT x kT: [j][p]
  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();
    for (int j = tid; j < jmax; j += kThreads) cumj[j] = cum_bc[j * h + hh];
    for (int p0 = 0; p0 < p; p0 += kT) {
      float acc[4][4] = {};                // [i = tx*4+u][p = ty*4+v]
      for (int j0 = 0; j0 < jmax; j0 += kT) {
        __syncthreads();
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int jj = e / kT, cc = e - jj * kT;
          const int j = j0 + jj, i = i0 + cc;
          ms[e] = (j <= i && i < q)
                      ? cbs[j * kT + cc] * expf(cumj[i] - cumj[j]) : 0.f;
          xs[e] = x_at(j, hh, p0 + cc);
        }
        __syncthreads();
        const int n_j = min(kT, jmax - j0);
        for (int jj = 0; jj < n_j; ++jj) {
          const float4 a = *reinterpret_cast<const float4*>(
              ms + jj * kT + tx * 4);
          const float4 bb = *reinterpret_cast<const float4*>(
              xs + jj * kT + ty * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + tx * 4 + u;
        if (i >= q) continue;
        float* yr = y + ((static_cast<long long>(bc) * q + i) * h + hh) * p;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int pp = p0 + ty * 4 + v;
          if (pp < p) yr[pp] = acc[u][v];
        }
      }
    }
  }
}

template <typename TX, typename TBC>
int launch(const void* x, long long xsb, long long xst, long long xsh,
           const void* dt, long long dsb, long long dst, const void* cum,
           const void* B, const void* C, long long bsb, long long bst,
           long long bsh, int b, int s, int nc, int q, int h, int p, int n,
           void* y, void* S, cudaStream_t stream) {
  const int q_r = (q + kT - 1) / kT * kT;
  const int work = max(2 * kT * (n + 1), 2 * kT * kT);
  const size_t smem = sizeof(float) * (q_r + q_r * kT + work);
  auto kern = ssd_chunk_kernel<TX, TBC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // heads share one cb only when B and C do (head stride 0)
  const int hpc = bsh == 0 ? kHeadsPerCta : 1;
  const dim3 grid(b * nc, q_r / kT + 1, (h + hpc - 1) / hpc);
  kern<<<grid, kThreads, smem, stream>>>(
      (const TX*)x, xsb, xst, xsh, (const float*)dt, dsb, dst,
      (const float*)cum, (const TBC*)B, (const TBC*)C, bsb, bst, bsh, s, nc,
      q, h, p, n, hpc, (float*)y, (float*)S);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x (b, s, h, p) at strides
// (xsb, xst, xsh) in x_dtype; dt (b, s, h) fp32 at strides (dsb, dst, 1);
// cum (b, nc, q, h) fp32 contiguous; B and C (b, s, [h,] n) at the shared
// strides (bsb, bst, bsh) in bc_dtype, bsh = 0 when one group serves every
// head; p and n contiguous.  y (b, nc, q, h, p) and S (b, nc, h, p, n) fp32
// contiguous.  q <= 256, n <= 256.
extern "C" int tardis_ssd_chunk(
    const void* x, long long xsb, long long xst, long long xsh,
    const void* dt, long long dsb, long long dst, const void* cum,
    const void* B, const void* C, long long bsb, long long bst,
    long long bsh, int b, int s, int nc, int q, int h, int p, int n,
    int x_dtype, int bc_dtype, void* y, void* S, void* stream) {
  if (b == 0 || nc == 0 || h == 0 || p == 0) return (int)cudaGetLastError();
  if (q <= 0 || q > kMaxQ || n <= 0 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && bc_dtype == 0)
    return launch<float, float>(x, xsb, xst, xsh, dt, dsb, dst, cum, B, C,
                                bsb, bst, bsh, b, s, nc, q, h, p, n, y, S,
                                st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, xsb, xst, xsh, dt, dsb, dst, cum, B, C, bsb, bst, bsh, b, s, nc,
        q, h, p, n, y, S, st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch<float, __nv_bfloat16>(x, xsb, xst, xsh, dt, dsb, dst, cum,
                                        B, C, bsb, bst, bsh, b, s, nc, q, h,
                                        p, n, y, S, st);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(x, xsb, xst, xsh, dt, dsb, dst, cum,
                                        B, C, bsb, bst, bsh, b, s, nc, q, h,
                                        p, n, y, S, st);
  return (int)cudaErrorInvalidValue;
}
