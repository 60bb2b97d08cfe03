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
// The SIMT kernel's grid: (b * nc, ceil(q / 64) + 1, ceil(h / 8)).  CTA
// y < the last computes 64 rows i of y_intra: first C_i . B_j for its rows
// and every j <= its last row, once, into shared memory (shared by its
// heads when the head stride is 0), then per head and 64-wide slice of p,
// per 64-position j tile: the decay-weighted M = cb * exp(cum_i - cum_j)
// (built in shared memory, never in device memory -- the plain version
// writes L and M at (b, nc, q, q, h) fp32, ~1 GB each per zamba2 layer)
// and the product M . xdt, 4 x 4 outputs per thread.  The last CTA row
// computes the chunk states S for its heads.
//
// Bound on the H100.  Per (chunk, head): ~q^2 (p + n) / 2 + q p n
// multiply-adds over ~q (p + 2n) * 2 + q p * 4 bytes.  The SIMT kernel
// below takes the bf16-x / fp32-B/C pair and the widths and views neither
// tensor-core variant takes; it is bound by its fp32 operations (no plain
// TF32: the fp32 tolerance is 2e-4); that first design lost ~8x to its
// bound: scalar staging with a bf16 convert and a dt multiply per element,
// 2-3 barriers per 64-position tile, a CTA row that computed the chunk
// states serially over 8 heads while the rows of y did triangular work,
// and ~100 KB of shared memory per 256-thread CTA.
//
// The tensor-core variant (x, B and C in bf16 -- what the serving path
// makes: column views of the conv output -- with p <= 64, n <= 128 and
// p, n in whole 16-byte vectors) is bound by its bytes (y_intra alone is
// q p * 4 bytes per (chunk, head)):
// * One CTA per (b, chunk, group of heads); 8 warps; B and C of the chunk
//   staged once (head stride 0) with 16-byte cp.async into rows swizzled
//   by 16-byte chunk, then per head its x tile, cum and dt, and
//   w_j = exp(cum_last - cum_j) * dt_j.
// * y: warp w takes the 16-row strips w and q/16 - 1 - w, so every warp
//   does the same triangular work; per 16 x 16 block (i, j <= i) it forms
//   C_i . B_j on mma.sync m16n8k16 (bf16 products exact, fp32 sums) into
//   registers (again per head: keeping it across heads would take 128 KB
//   of shared memory), folds the decay and dt_j into M'_ij = cb_ij *
//   exp(cum_i - cum_j) * dt_j (the exponential only where j <= i) and
//   feeds M' as A fragments in three bf16 parts whose sum is
//   the fp32 M' (8 + 8 + 8 significant bits) against the bf16 x tile:
//   every product exact, summed in fp32 -- the plain version's numbers to
//   fp32 rounding, no new rounding contract.  Blocks above the diagonal
//   are skipped.
// * S: B_j * w_j in three bf16 parts times bf16 x, the work of 16 columns
//   of n by 32 of p a warp, so the states balance across the warps too.
// (ssd_chunk_split_ref in ref.py is this arithmetic in PyTorch.)
//
// The fp32-x pairs with p <= 64, n <= 128 (training's forward) run the
// "tf32x3" variant of ssd_chunk_tf32.cu: its products on the tensor cores
// as three TF32 products, C.B^T formed once per CTA for all its heads.
// The SIMT kernel above is left for the shapes and views no tensor-core
// variant takes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tardis_hopper.cuh"

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


// ---- the tensor-core variant: bf16 x, B and C ------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaP = 64;        // p at most: an x row is one 128-byte atom
constexpr int kXPitch = 128;

template <int NMAX>
__host__ __device__ constexpr size_t mma_smem(int q) {
  return static_cast<size_t>(q) * (kXPitch + 2 * swz_pitch(NMAX)) +
         sizeof(float) * 3 * q;
}

// NMAX: n at most (64: two CTAs an SM; 128: one)
template <int NMAX>
__global__ void __launch_bounds__(kMmaWarps * 32, NMAX <= 64 ? 2 : 1)
    ssd_chunk_mma(const __nv_bfloat16* __restrict__ x, long long xsb,
                  long long xst, long long xsh, const float* __restrict__ dt,
                  long long dsb, long long dst, const float* __restrict__ cum,
                  const __nv_bfloat16* __restrict__ B,
                  const __nv_bfloat16* __restrict__ C, long long bsb,
                  long long bst, long long bsh, int s, int nc, int q, int h,
                  int p, int n, int hpc, float* __restrict__ y,
                  float* __restrict__ S) {
  constexpr int BP = swz_pitch(NMAX), NK = NMAX / 16;
  constexpr int PB = kMmaP / 8;            // 8-wide column blocks of p
  extern __shared__ uint4 smem_mma[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(smem_mma);
  unsigned char* bs = xs + q * kXPitch;    // [j][n], swizzled
  unsigned char* cs = bs + q * BP;         // [i][n], swizzled
  float* cum_s = reinterpret_cast<float*>(cs + q * BP);
  float* dt_s = cum_s + q;
  float* w_s = dt_s + q;

  const int bc = blockIdx.x;
  const int bi = bc / nc, c = bc - bi * nc;
  const int h0 = blockIdx.y * hpc, h1 = min(h, h0 + hpc);
  const long long t_base = static_cast<long long>(c) * q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int pk = (p + 15) / 16, nk = (n + 15) / 16;  // 16-wide steps
  const int ns = q / 16;                              // 16-row strips
  const float* cum_bc = cum + static_cast<long long>(bc) * q * h;

  // rows j < q of one (b, chunk) as 16-byte vectors into swizzled rows;
  // zeros past s and past `cols` (up to whole 16-column steps)
  auto stage = [&](unsigned char* dst, int pitch, const __nv_bfloat16* src,
                   long long row_stride, int cols, int steps) {
    const int nch = 2 * steps;
    for (int e = tid; e < q * nch; e += kMmaWarps * 32) {
      const int j = e / nch, ch = e - j * nch;
      const long long t = t_base + j;
      const bool ok = t < s && ch * 8 < cols;
      cp_async16(dst + swz(j, ch, pitch),
                 ok ? src + t * row_stride + ch * 8 : src, ok);
    }
  };
  float cum_r = 0.f, dt_r = 0.f;         // row tid of the next head
  auto fetch = [&](int hh) {
    if (tid < q) {
      const long long t = t_base + tid;
      cum_r = cum_bc[static_cast<long long>(tid) * h + hh];
      dt_r = t < s ? dt[bi * dsb + t * dst + hh] : 0.f;
    }
  };
  fetch(h0);

  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();                      // the last head's tiles are read
    if (hh == h0 || bsh != 0) {           // B and C: once when shared
      stage(bs, BP, B + bi * bsb + hh * bsh, bst, n, nk);
      stage(cs, BP, C + bi * bsb + hh * bsh, bst, n, nk);
    }
    stage(xs, kXPitch, x + bi * xsb + hh * xsh, xst, p, pk);
    cp_async_commit();
    if (tid < q) {
      cum_s[tid] = cum_r;
      dt_s[tid] = dt_r;
    }
    if (hh + 1 < h1) fetch(hh + 1);
    __syncthreads();
    if (tid < q)
      w_s[tid] = ex2((cum_s[q - 1] - cum_s[tid]) * kTardisLog2e) * dt_s[tid];
    cp_async_wait<0>();
    __syncthreads();

    // ---- y_intra: the strips u and ns - 1 - u of warp u ------------------
    for (int u = warp; u < (ns + 1) / 2; u += kMmaWarps) {
      for (int side = 0; side < 2; ++side) {
        const int st = side ? ns - 1 - u : u;
        if (side && st == u) break;
        const int i0 = st * 16, r0 = i0 + grp, r1 = r0 + 8;
        const float ci0 = cum_s[r0], ci1 = cum_s[r1];
        unsigned ca[NK][4];               // C rows of the strip, k = n
#pragma unroll
        for (int kn = 0; kn < NK; ++kn)
          if (kn < nk)
            ldmatrix_x4(ca[kn], cs + swz(i0 + (lane & 7) + 8 * (mi & 1),
                                         2 * kn + (mi >> 1), BP));
        float acc[PB][4];
#pragma unroll
        for (int nd = 0; nd < PB; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
        for (int kj = 0; kj <= st; ++kj) {
          const int j0 = kj * 16;
          // cb = C_i . B_j: 16 rows i x 16 columns j (two n-blocks)
          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kn = 0; kn < NK; ++kn)
            if (kn < nk) {
              unsigned bf[4];
              ldmatrix_x4(bf, bs + swz(j0 + (mi >> 1) * 8 + (lane & 7),
                                       2 * kn + (mi & 1), BP));
              mma_bf16_16(cb[0], ca[kn], bf[0], bf[1]);
              mma_bf16_16(cb[1], ca[kn], bf[2], bf[3]);
            }
          // M' = cb * exp(cum_i - cum_j) * dt_j where j <= i (else 0: the
          // exponential past the diagonal may overflow), as three bf16
          // parts in A fragment order (a0 rows r0 / a1 rows r1 of columns
          // 0-7, a2 / a3 of columns 8-15)
          unsigned ma[3][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int j = j0 + nb * 8 + 2 * tig;
            const float2 cj = *reinterpret_cast<const float2*>(cum_s + j);
            const float2 dj = *reinterpret_cast<const float2*>(dt_s + j);
            float v[4];
            v[0] = j <= r0 ? cb[nb][0] * ex2((ci0 - cj.x) * kTardisLog2e) *
                                 dj.x : 0.f;
            v[1] = j + 1 <= r0 ? cb[nb][1] *
                                     ex2((ci0 - cj.y) * kTardisLog2e) * dj.y
                               : 0.f;
            v[2] = j <= r1 ? cb[nb][2] * ex2((ci1 - cj.x) * kTardisLog2e) *
                                 dj.x : 0.f;
            v[3] = j + 1 <= r1 ? cb[nb][3] *
                                     ex2((ci1 - cj.y) * kTardisLog2e) * dj.y
                               : 0.f;
            unsigned lo[3], hi[3];
            split3(v[0], v[1], lo);
            split3(v[2], v[3], hi);
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              ma[part][2 * nb] = lo[part];
              ma[part][2 * nb + 1] = hi[part];
            }
          }
          // y += M' . x: x's [j][p] rows as B fragments (ldmatrix.trans)
#pragma unroll
          for (int nd = 0; nd < PB; nd += 2)
            if (nd < 2 * pk) {
              unsigned vf[4];
              ldmatrix_x4_trans(vf, xs + swz(j0 + (mi & 1) * 8 + (lane & 7),
                                             nd + (mi >> 1), kXPitch));
#pragma unroll
              for (int part = 0; part < 3; ++part) {
                mma_bf16_16(acc[nd], ma[part], vf[0], vf[1]);
                mma_bf16_16(acc[nd + 1], ma[part], vf[2], vf[3]);
              }
            }
        }
        float* y0 = y + ((static_cast<long long>(bc) * q + r0) * h + hh) * p;
        float* y1 = y0 + 8LL * h * p;
#pragma unroll
        for (int nd = 0; nd < PB; ++nd) {
          const int col = nd * 8 + 2 * tig;
          if (col < p) {
            *reinterpret_cast<float2*>(y0 + col) =
                make_float2(acc[nd][0], acc[nd][1]);
            *reinterpret_cast<float2*>(y1 + col) =
                make_float2(acc[nd][2], acc[nd][3]);
          }
        }
      }
    }

    // ---- S: 16 columns of n by up to 32 rows of p a unit ----------------
    const int n_units = nk * ((pk + 1) / 2);
    for (int u = warp; u < n_units; u += kMmaWarps) {
      const int np = u % nk, sp0 = 2 * (u / nk);
      float acc[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b2][e] = 0.f;
      for (int kj = 0; kj < ns; ++kj) {
        const int j0 = kj * 16;
        // B_j * w_j as B fragments (k = j, columns n), three bf16 parts:
        // bfr[0] / bfr[1] rows j0 + 2 tig (+1) / j0 + 8 + 2 tig (+1) of
        // n-block 2 np, bfr[2] / bfr[3] of n-block 2 np + 1
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, bs + swz(j0 + (mi & 1) * 8 + (lane & 7),
                                        2 * np + (mi >> 1), BP));
        const float2 wa = *reinterpret_cast<const float2*>(w_s + j0 + 2 * tig);
        const float2 wb =
            *reinterpret_cast<const float2*>(w_s + j0 + 8 + 2 * tig);
        unsigned bw[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 w = (k & 1) ? wb : wa;
          split3(bf16_lo(bfr[k]) * w.x, bf16_hi(bfr[k]) * w.y, bw[k]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
          if (sp0 + a < pk) {
            unsigned xa[4];               // x^T: rows p, k = j
            ldmatrix_x4_trans(xa, xs + swz(j0 + (lane & 7) + 8 * (mi >> 1),
                                           2 * (sp0 + a) + (mi & 1),
                                           kXPitch));
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              mma_bf16_16(acc[a][0], xa, bw[0][part], bw[1][part]);
              mma_bf16_16(acc[a][1], xa, bw[2][part], bw[3][part]);
            }
          }
      }
      float* sh = S + (static_cast<long long>(bc) * h + hh) * p * n;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2) {
          const int pr = (sp0 + a) * 16 + grp;
          const int col = np * 16 + b2 * 8 + 2 * tig;
          if (col >= n) continue;
          if (pr < p)
            *reinterpret_cast<float2*>(sh + static_cast<long long>(pr) * n +
                                       col) =
                make_float2(acc[a][b2][0], acc[a][b2][1]);
          if (pr + 8 < p)
            *reinterpret_cast<float2*>(
                sh + static_cast<long long>(pr + 8) * n + col) =
                make_float2(acc[a][b2][2], acc[a][b2][3]);
        }
    }
  }
}

template <int NMAX>
int launch_mma(const void* x, long long xsb, long long xst, long long xsh,
               const void* dt, long long dsb, long long dst, const void* cum,
               const void* B, const void* C, long long bsb, long long bst,
               long long bsh, int b, int s, int nc, int q, int h, int p,
               int n, int hpc, void* y, void* S, cudaStream_t stream) {
  const size_t smem = mma_smem<NMAX>(q);
  auto kern = ssd_chunk_mma<NMAX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(b * nc, (h + hpc - 1) / hpc);
  kern<<<grid, kMmaWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)x, xsb, xst, xsh, (const float*)dt, dsb, dst,
      (const float*)cum, (const __nv_bfloat16*)B, (const __nv_bfloat16*)C,
      bsb, bst, bsh, s, nc, q, h, p, n, hpc, (float*)y, (float*)S);
  return (int)cudaGetLastError();
}

}  // namespace

// the tf32x3 variant (ssd_chunk_tf32.cu)
int tardis_ssd_chunk_tf32(const void* x, long long xsb, long long xst,
                          long long xsh, const void* dt, long long dsb,
                          long long dst, const void* cum, const void* B,
                          const void* C, long long bsb, long long bst,
                          long long bsh, int b, int s, int nc, int q, int h,
                          int p, int n, int bc_dtype, int heads_per_cta,
                          void* y, void* S, cudaStream_t stream);

// dtype codes: 0 = float32, 1 = bfloat16.  x (b, s, h, p) at strides
// (xsb, xst, xsh) in x_dtype; dt (b, s, h) fp32 at strides (dsb, dst, 1);
// cum (b, nc, q, h) fp32 contiguous; B and C (b, s, [h,] n) at the shared
// strides (bsb, bst, bsh) in bc_dtype, bsh = 0 when one group serves every
// head; p and n contiguous.  y (b, nc, q, h, p) and S (b, nc, h, p, n) fp32
// contiguous.  q <= 256, n <= 256.  variant (the caller decides): 0 the
// SIMT kernel (any dtype pair); 1 the bf16 tensor-core kernel ("mma": x
// and B/C bf16, q a multiple of 16, p <= 64 and n <= 128 multiples of 8,
// x, B and C 16-byte aligned with strides in multiples of 8 elements); 2
// "tf32x3" (fp32 x over fp32 or bf16 B/C, q a multiple of 16, p <= 64 and
// n <= 128 multiples of 8, x 16-byte aligned with strides in multiples of
// 4 elements).  The tensor-core variants take heads_per_cta heads a CTA.
extern "C" int tardis_ssd_chunk(
    const void* x, long long xsb, long long xst, long long xsh,
    const void* dt, long long dsb, long long dst, const void* cum,
    const void* B, const void* C, long long bsb, long long bst,
    long long bsh, int b, int s, int nc, int q, int h, int p, int n,
    int x_dtype, int bc_dtype, int variant, int heads_per_cta, void* y,
    void* S, void* stream) {
  if (b == 0 || nc == 0 || h == 0 || p == 0) return (int)cudaGetLastError();
  if (q <= 0 || q > kMaxQ || n <= 0 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 2) {
    if (x_dtype != 0) return (int)cudaErrorInvalidValue;
    return tardis_ssd_chunk_tf32(x, xsb, xst, xsh, dt, dsb, dst, cum, B, C,
                                 bsb, bst, bsh, b, s, nc, q, h, p, n,
                                 bc_dtype, heads_per_cta, y, S, st);
  }
  if (variant == 1) {
    if (x_dtype != 1 || bc_dtype != 1 || q % 16 || p % 8 || p > kMmaP ||
        n % 8 || n > 128 || heads_per_cta <= 0)
      return (int)cudaErrorInvalidValue;
    if ((xsb | xst | xsh | bsb | bst | bsh) % 8 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
         reinterpret_cast<uintptr_t>(C)) % 16)
      return (int)cudaErrorMisalignedAddress;
    if (n <= 64)
      return launch_mma<64>(x, xsb, xst, xsh, dt, dsb, dst, cum, B, C, bsb,
                            bst, bsh, b, s, nc, q, h, p, n, heads_per_cta, y,
                            S, st);
    return launch_mma<128>(x, xsb, xst, xsh, dt, dsb, dst, cum, B, C, bsb,
                           bst, bsh, b, s, nc, q, h, p, n, heads_per_cta, y,
                           S, st);
  }
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
