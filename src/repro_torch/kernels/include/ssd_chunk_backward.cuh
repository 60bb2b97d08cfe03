// K12 ssd_chunk_backward's kernels and launchers, shared by the two
// sources that instantiate them (ssd_scan/csrc/ssd_chunk_backward.cu for
// an fp32 x, ssd_chunk_backward_bf16.cu for a bf16 x: two nvcc processes
// that build side by side).  The design is described in
// ssd_chunk_backward.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k12 {
namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;         // tile edge: positions i, j; columns p, n
constexpr int kLdT = kT + 1;   // pitch of a 64 x 64 tile
constexpr int kMaxQ = 256;
constexpr int kMaxPN = 128;    // p and n at most: two 64-column slices

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

// The operands of one (b, chunk, head) and the reads of its positions.
template <typename TX, typename TBC>
struct Chunk {
  const TX* x; long long xsb, xst, xsh;
  const float* dt; long long dsb, dst;
  const TBC* B; const TBC* C; long long bsb, bst, bsh;
  const float* dy;   // (b, nc, q, h, p)
  int bi, bc, hh, s, q, h, p, n;
  long long t_base;

  __device__ bool live(int j) const { return j < q && t_base + j < s; }
  __device__ float xv(int j, int pp) const {       // x, 0 past s
    if (!live(j)) return 0.f;
    return to_f32(x[bi * xsb + (t_base + j) * xst + hh * xsh + pp]);
  }
  __device__ float dtv(int j) const {
    if (!live(j)) return 0.f;
    return dt[bi * dsb + (t_base + j) * dst + hh];
  }
  __device__ float bcv(const TBC* m, int j, int nn) const {
    if (!live(j)) return 0.f;
    return to_f32(m[bi * bsb + (t_base + j) * bst + hh * bsh + nn]);
  }
  __device__ float dyv(int i, int pp) const {
    if (i >= q) return 0.f;
    return dy[((static_cast<long long>(bc) * q + i) * h + hh) * p + pp];
  }
};

// rows r0 .. r0 + 63 of B or C into [r][k] at pitch n + 1
template <typename TX, typename TBC>
__device__ void stage_bc(float* dst, const Chunk<TX, TBC>& ch, const TBC* m,
                         int r0) {
  const int ld = ch.n + 1;
  for (int e = threadIdx.x; e < kT * ch.n; e += kThreads) {
    const int r = e / ch.n, k = e - r * ch.n;
    dst[r * ld + k] = ch.bcv(m, r0 + r, k);
  }
}

// rows of xdt (x dt) or dy into [r][k] at pitch p + 1
template <typename TX, typename TBC>
__device__ void stage_xdt(float* dst, const Chunk<TX, TBC>& ch, int r0) {
  const int ld = ch.p + 1;
  for (int e = threadIdx.x; e < kT * ch.p; e += kThreads) {
    const int r = e / ch.p, k = e - r * ch.p;
    dst[r * ld + k] = ch.xv(r0 + r, k) * ch.dtv(r0 + r);
  }
}
template <typename TX, typename TBC>
__device__ void stage_dy(float* dst, const Chunk<TX, TBC>& ch, int r0) {
  const int ld = ch.p + 1;
  for (int e = threadIdx.x; e < kT * ch.p; e += kThreads) {
    const int r = e / ch.p, k = e - r * ch.p;
    dst[r * ld + k] = ch.dyv(r0 + r, k);
  }
}

// The (i-block, j-block) tile: cb[u][v] = C_i . B_j and dm[u][v] =
// dy_i . xdt_j for i = ty * 4 + u, j = tx * 4 + v of the blocks.
__device__ __forceinline__ void tile_cb_dm(
    const float* cs, const float* bs, const float* dys, const float* xs,
    int n, int p, int ty, int tx, float (&cb)[4][4], float (&dm)[4][4]) {
  const int ldn = n + 1, ldp = p + 1;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) cb[u][v] = dm[u][v] = 0.f;
  for (int k = 0; k < n; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = cs[(ty * 4 + u) * ldn + k];
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = bs[(tx * 4 + v) * ldn + k];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) cb[u][v] += a[u] * b[v];
  }
  for (int k = 0; k < p; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = dys[(ty * 4 + u) * ldp + k];
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = xs[(tx * 4 + v) * ldp + k];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) dm[u][v] += a[u] * b[v];
  }
}

// L_ij for the tile's (i, j): exp(cum_i - cum_j) where j <= i < q, else 0
// (the exponential only there: past the diagonal it can overflow)
__device__ __forceinline__ float decay(int i, int j, int q, float ci,
                                       float cj) {
  return (j <= i && i < q) ? expf(ci - cj) : 0.f;
}

// sum over the 16 threads that hold tile row r (red: 64 x 17), in their
// order; thread t < 64 gets row t's sum, valid where row t was among the
// rows written by this call (t % 4 equal to the caller's slot)
__device__ __forceinline__ float row_sum16(float* red, int r, int col,
                                           float v) {
  red[r * 17 + col] = v;
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < kT)
    for (int k = 0; k < 16; ++k) sum += red[threadIdx.x * 17 + k];
  __syncthreads();
  return sum;
}

template <int S>
__device__ __forceinline__ void zero(float (&a)[S][4][4]) {
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) a[k][u][v] = 0.f;
}

// ---- kernel 1: dC and the row sums of dM o M --------------------------
template <typename TX, typename TBC, int NS>
__global__ void __launch_bounds__(kThreads) ssd_bwd_rows(
    Chunk<TX, TBC> ch, int nc, const float* __restrict__ cum,
    float* __restrict__ dcum_row, float* __restrict__ dc_head) {
  ch.bc = blockIdx.x;
  ch.bi = ch.bc / nc;
  ch.hh = blockIdx.z;
  ch.t_base = static_cast<long long>(ch.bc - ch.bi * nc) * ch.q;
  const int n = ch.n, p = ch.p, q = ch.q, h = ch.h;
  const int ldn = n + 1, ldp = p + 1;
  extern __shared__ float smem[];
  float* cs = smem;                  // C rows i   [i][n]
  float* dys = cs + kT * ldn;        // dy rows i  [i][p]
  float* bs = dys + kT * ldp;        // B rows j   [j][n]
  float* xs = bs + kT * ldn;         // xdt rows j [j][p]
  float* ts = xs + kT * ldp;         // dcb        [i][j]
  float* cumi = ts + kT * kLdT;
  float* cumj = cumi + kT;
  float* red = cumj + kT;            // 64 x 17
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * kT;
  const float* cum_bc = cum + static_cast<long long>(ch.bc) * q * h;

  stage_bc(cs, ch, ch.C, i0);
  stage_dy(dys, ch, i0);
  for (int r = tid; r < kT; r += kThreads)
    cumi[r] = i0 + r < q ? cum_bc[(i0 + r) * h + ch.hh] : 0.f;
  float acc[NS][4][4];
  zero(acc);
  float rowpart[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    __syncthreads();
    stage_bc(bs, ch, ch.B, j0);
    stage_xdt(xs, ch, j0);
    for (int r = tid; r < kT; r += kThreads)
      cumj[r] = j0 + r < q ? cum_bc[(j0 + r) * h + ch.hh] : 0.f;
    __syncthreads();
    float cb[4][4], dm[4][4];
    tile_cb_dm(cs, bs, dys, xs, n, p, ty, tx, cb, dm);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty * 4 + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = tx * 4 + v;
        const float l = decay(i0 + r, j0 + c, q, cumi[r], cumj[c]);
        const float dcb = dm[u][v] * l;
        rowpart[u] += dcb * cb[u][v];
        ts[r * kLdT + c] = dcb;
      }
    }
    __syncthreads();
    // dC_i += dcb_i. B_j
    for (int c = 0; c < kT; ++c) {
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = ts[(ty * 4 + u) * kLdT + c];
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int nn = k * kT + tx * 4 + v;
          const float b = nn < n ? bs[c * ldn + nn] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k][u][v] += a[u] * b;
        }
    }
  }
  // the row sums of dM o M over the tile rows' 16 threads
  __syncthreads();
  float rsum = 0.f;                  // thread t < 64: row i0 + t's sum
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float sum = row_sum16(red, ty * 4 + u, tx, rowpart[u]);
    if ((tid & 3) == u) rsum = sum;
  }
  if (tid < kT && i0 + tid < q)
    dcum_row[(static_cast<long long>(ch.bc) * q + i0 + tid) * h + ch.hh] =
        rsum;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty * 4 + u;
    if (!ch.live(i)) continue;
    float* out = dc_head + ((ch.bi * static_cast<long long>(ch.s)
                             + ch.t_base + i) * h + ch.hh) * n;
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nn = k * kT + tx * 4 + v;
        if (nn < n) out[nn] = acc[k][u][v];
      }
  }
}

// ---- kernel 2: dxdt (dx, ddt), dB, the column sums and the e terms ----
template <typename TX, typename TBC, int PS, int NS>
__global__ void __launch_bounds__(kThreads) ssd_bwd_cols(
    Chunk<TX, TBC> ch, int nc, const float* __restrict__ cum,
    const float* __restrict__ dS, float* __restrict__ dcum_col,
    float* __restrict__ elast, TX* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ db_head) {
  ch.bc = blockIdx.x;
  ch.bi = ch.bc / nc;
  ch.hh = blockIdx.z;
  ch.t_base = static_cast<long long>(ch.bc - ch.bi * nc) * ch.q;
  const int n = ch.n, p = ch.p, q = ch.q, h = ch.h;
  const int ldn = n + 1, ldp = p + 1;
  const int nblk = gridDim.y;
  extern __shared__ float smem[];
  float* bs = smem;                  // B rows j   [j][n]
  float* xs = bs + kT * ldn;         // xdt rows j [j][p]
  float* cs = xs + kT * ldp;         // C rows i   [i][n]; then dS [p][n]
  float* dys = cs + kT * ldn;        // dy rows i  [i][p]
  float* ms = dys + kT * ldp;        // M          [i][j]
  float* ds = ms + kT * kLdT;        // dcb        [i][j]
  float* cumi = ds + kT * kLdT;
  float* cumj = cumi + kT;
  float* red = cumj + kT;            // 64 x 17
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.y * kT;
  const float* cum_bc = cum + static_cast<long long>(ch.bc) * q * h;

  stage_bc(bs, ch, ch.B, j0);
  stage_xdt(xs, ch, j0);
  for (int r = tid; r < kT; r += kThreads)
    cumj[r] = j0 + r < q ? cum_bc[(j0 + r) * h + ch.hh] : 0.f;
  float adx[PS][4][4], adb[NS][4][4];
  zero(adx);
  zero(adb);
  float colpart[4] = {0.f, 0.f, 0.f, 0.f};   // columns j = tx * 4 + v
  for (int i0 = j0; i0 < nblk * kT; i0 += kT) {
    __syncthreads();
    stage_bc(cs, ch, ch.C, i0);
    stage_dy(dys, ch, i0);
    for (int r = tid; r < kT; r += kThreads)
      cumi[r] = i0 + r < q ? cum_bc[(i0 + r) * h + ch.hh] : 0.f;
    __syncthreads();
    float cb[4][4], dm[4][4];
    tile_cb_dm(cs, bs, dys, xs, n, p, ty, tx, cb, dm);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty * 4 + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = tx * 4 + v;
        const float l = decay(i0 + r, j0 + c, q, cumi[r], cumj[c]);
        const float m = cb[u][v] * l;
        colpart[v] += dm[u][v] * m;
        ms[r * kLdT + c] = m;
        ds[r * kLdT + c] = dm[u][v] * l;
      }
    }
    __syncthreads();
    // rows j = ty * 4 + u: dxdt_j += M_ij dy_i, dB_j += dcb_ij C_i
    for (int i = 0; i < kT; ++i) {
      float m[4], d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m[u] = ms[i * kLdT + ty * 4 + u];
        d[u] = ds[i * kLdT + ty * 4 + u];
      }
#pragma unroll
      for (int k = 0; k < PS; ++k)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int pp = k * kT + tx * 4 + v;
          const float g = pp < p ? dys[i * ldp + pp] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) adx[k][u][v] += m[u] * g;
        }
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int nn = k * kT + tx * 4 + v;
          const float c = nn < n ? cs[i * ldn + nn] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) adb[k][u][v] += d[u] * c;
        }
    }
  }
  // the column sums of dM o M over the tile columns' 16 threads
  __syncthreads();
  float colsum = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float sum = row_sum16(red, tx * 4 + v, ty, colpart[v]);
    if ((tid & 3) == v) colsum = sum;
  }

  // the e terms: dS of this (b, chunk, head) staged over cs / dys
  float* dss = cs;                   // [p][n] at pitch n + 1
  const float* dS_h = dS + (static_cast<long long>(ch.bc) * h + ch.hh) * p * n;
  for (int e = tid; e < p * n; e += kThreads) {
    const int pp = e / n, nn = e - pp * n;
    dss[pp * ldn + nn] = dS_h[e];
  }
  const float cum_last = cum_bc[(q - 1) * h + ch.hh];
  __syncthreads();
  float ev[4], depart[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + ty * 4 + u;
    ev[u] = j < q ? expf(cum_last - cumj[ty * 4 + u]) : 0.f;
    depart[u] = 0.f;
  }
  // BdS_j[p] = B_j . dS[p]: into dxdt with e_j, and de_j = xdt_j . BdS_j
#pragma unroll
  for (int k = 0; k < PS; ++k) {
    float t[4][4] = {};
    for (int nn = 0; nn < n; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = bs[(ty * 4 + u) * ldn + nn];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pp = k * kT + tx * 4 + v;
        b[v] = pp < p ? dss[pp * ldn + nn] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) t[u][v] += a[u] * b[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pp = k * kT + tx * 4 + v;
        if (pp < p) depart[u] += xs[(ty * 4 + u) * ldp + pp] * t[u][v];
        adx[k][u][v] += ev[u] * t[u][v];
      }
  }
  // xdS_j[n] = xdt_j . dS[:, n]: into dB with e_j
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float t[4][4] = {};
    for (int pp = 0; pp < p; ++pp) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = xs[(ty * 4 + u) * ldp + pp];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nn = k * kT + tx * 4 + v;
        b[v] = nn < n ? dss[pp * ldn + nn] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) t[u][v] += a[u] * b[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) adb[k][u][v] += ev[u] * t[u][v];
  }
  __syncthreads();
  float de = 0.f;                    // thread t < 64: de of row j0 + t
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float sum = row_sum16(red, ty * 4 + u, tx, depart[u]);
    if ((tid & 3) == u) de = sum;
  }
  // dcum's column part and this block's share of dcum_last
  float* shares = red;               // 64 floats: de_j e_j
  if (tid < kT) {
    const int j = j0 + tid;
    const float e = j < q ? expf(cum_last - cumj[tid]) : 0.f;
    shares[tid] = de * e;
    if (j < q)
      dcum_col[(static_cast<long long>(ch.bc) * q + j) * h + ch.hh] =
          -colsum - de * e;
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int k = 0; k < kT; ++k) sum += shares[k];
    elast[(static_cast<long long>(ch.bc) * h + ch.hh) * nblk + blockIdx.y] =
        sum;
  }
  __syncthreads();
  // dx = dxdt dt, ddt = dxdt . x, dB's per-head part
  float ddp[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + ty * 4 + u;
    ddp[u] = 0.f;
    if (!ch.live(j)) continue;
    const float dtj = ch.dtv(j);
    const long long row = (ch.bi * static_cast<long long>(ch.s) + ch.t_base
                           + j) * h + ch.hh;
#pragma unroll
    for (int k = 0; k < PS; ++k)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pp = k * kT + tx * 4 + v;
        if (pp < p) {
          dx[row * p + pp] = from_f32<TX>(adx[k][u][v] * dtj);
          ddp[u] += adx[k][u][v] * ch.xv(j, pp);
        }
      }
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nn = k * kT + tx * 4 + v;
        if (nn < n) db_head[row * n + nn] = adb[k][u][v];
      }
  }
  float dd = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float sum = row_sum16(red, ty * 4 + u, tx, ddp[u]);
    if ((tid & 3) == u) dd = sum;
  }
  if (tid < kT && ch.live(j0 + tid))
    ddt[(ch.bi * static_cast<long long>(ch.s) + ch.t_base + j0 + tid) * h
        + ch.hh] = dd;
}

// ---- kernel 3: dcum, and dB / dC from the per-head partials -------------
template <typename TBC>
__global__ void ssd_bwd_finish(const float* __restrict__ dcum_row,
                               const float* __restrict__ dcum_col,
                               const float* __restrict__ elast, int q, int h,
                               int nblk, long long n_cum,
                               float* __restrict__ dcum,
                               const float* __restrict__ db_head,
                               const float* __restrict__ dc_head, int n,
                               int hs, long long n_bc, TBC* __restrict__ db,
                               TBC* __restrict__ dc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x; o < n_cum; o += stride) {
    const long long bc = o / (static_cast<long long>(q) * h);
    const int rem = static_cast<int>(o - bc * q * h);
    const int i = rem / h, hh = rem - i * h;
    float v = dcum_row[o] + dcum_col[o];
    if (i == q - 1) {
      const float* sh = elast + (bc * h + hh) * nblk;
      float sum = 0.f;
      for (int k = 0; k < nblk; ++k) sum += sh[k];
      v += sum;
    }
    dcum[o] = v;
  }
  // an output element sums hs heads' partials (hs = h where one group
  // serves every head, else 1), in head order
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x; o < n_bc; o += stride) {
    const long long base = (o / n) * hs * n + o % n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < hs; ++k) {
      sb += db_head[base + static_cast<long long>(k) * n];
      sc += dc_head[base + static_cast<long long>(k) * n];
    }
    db[o] = from_f32<TBC>(sb);
    dc[o] = from_f32<TBC>(sc);
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TX, typename TBC, int PS, int NS>
int launch(const Chunk<TX, TBC>& ch, int b, int nc, const float* cum,
           const float* dS, float* dcum_row, float* dcum_col, float* elast,
           float* dc_head, float* db_head, TX* dx, float* ddt, float* dcum,
           TBC* db, TBC* dc, int shared, cudaStream_t st) {
  const int nblk = (ch.q + kT - 1) / kT;
  const int ldn = ch.n + 1, ldp = ch.p + 1;
  const size_t tail = 2 * kT + kT * 17;
  const size_t smem_r =
      sizeof(float) * (2 * kT * ldn + 2 * kT * ldp + kT * kLdT + tail);
  const size_t smem_c =
      sizeof(float) * (2 * kT * ldn + 2 * kT * ldp + 2 * kT * kLdT + tail);
  auto rows = ssd_bwd_rows<TX, TBC, NS>;
  auto cols = ssd_bwd_cols<TX, TBC, PS, NS>;
  int e = allow_smem(rows, smem_r);
  if (e) return e;
  if ((e = allow_smem(cols, smem_c))) return e;
  const dim3 grid(b * nc, nblk, ch.h);
  rows<<<grid, kThreads, smem_r, st>>>(ch, nc, cum, dcum_row, dc_head);
  if ((e = (int)cudaGetLastError())) return e;
  cols<<<grid, kThreads, smem_c, st>>>(ch, nc, cum, dS, dcum_col, elast, dx,
                                       ddt, db_head);
  if ((e = (int)cudaGetLastError())) return e;
  const long long n_cum = static_cast<long long>(b) * nc * ch.q * ch.h;
  const int hs = shared ? ch.h : 1;
  const long long n_bc =
      static_cast<long long>(b) * ch.s * (ch.h / hs) * ch.n;
  const long long most = n_cum > n_bc ? n_cum : n_bc;
  const int blocks = static_cast<int>(
      (most + 255) / 256 < 4096 ? (most + 255) / 256 : 4096);
  ssd_bwd_finish<TBC><<<blocks, 256, 0, st>>>(
      dcum_row, dcum_col, elast, ch.q, ch.h, nblk, n_cum, dcum, db_head,
      dc_head, ch.n, hs, n_bc, db, dc);
  return (int)cudaGetLastError();
}

template <typename TX, typename TBC>
int dispatch(const void* x, long long xsb, long long xst, long long xsh,
             const void* dt, long long dsb, long long dst, const void* cum,
             const void* B, const void* C, long long bsb, long long bst,
             long long bsh, const void* dy, const void* dS, int b, int s,
             int nc, int q, int h, int p, int n, int shared, void* dcum_row,
             void* dcum_col, void* elast, void* dc_head, void* db_head,
             void* dx, void* ddt, void* dcum, void* dB, void* dC,
             cudaStream_t st) {
  Chunk<TX, TBC> ch{(const TX*)x, xsb, xst, xsh, (const float*)dt, dsb, dst,
                    (const TBC*)B, (const TBC*)C, bsb, bst, bsh,
                    (const float*)dy, 0, 0, 0, s, q, h, p, n, 0};
#define K12_LAUNCH(PS, NS)                                                  \
  return launch<TX, TBC, PS, NS>(                                           \
      ch, b, nc, (const float*)cum, (const float*)dS, (float*)dcum_row,     \
      (float*)dcum_col, (float*)elast, (float*)dc_head, (float*)db_head,    \
      (TX*)dx, (float*)ddt, (float*)dcum, (TBC*)dB, (TBC*)dC, shared, st)
  if (p <= kT && n <= kT) K12_LAUNCH(1, 1);
  if (p <= kT) K12_LAUNCH(1, 2);
  if (n <= kT) K12_LAUNCH(2, 1);
  K12_LAUNCH(2, 2);
#undef K12_LAUNCH
}

}  // namespace
}  // namespace k12

// every operand of the C entry point, in its order
#define K12_PARAMS                                                           \
  const void *x, long long xsb, long long xst, long long xsh,               \
      const void *dt, long long dsb, long long dst, const void *cum,        \
      const void *B, const void *C, long long bsb, long long bst,           \
      long long bsh, const void *dy, const void *dS, int b, int s, int nc,  \
      int q, int h, int p, int n, int shared, int bc_dtype,                 \
      void *dcum_row, void *dcum_col, void *elast, void *dc_head,           \
      void *db_head, void *dx, void *ddt, void *dcum, void *dB, void *dC,   \
      cudaStream_t st
#define K12_ARGS                                                             \
  x, xsb, xst, xsh, dt, dsb, dst, cum, B, C, bsb, bst, bsh, dy, dS, b, s,   \
      nc, q, h, p, n, shared, bc_dtype, dcum_row, dcum_col, elast, dc_head, \
      db_head, dx, ddt, dcum, dB, dC, st

// K12 for an x of type TX, B / C in fp32 (bc_dtype 0) or bf16 (1)
template <typename TX>
int k12_for_x(K12_PARAMS) {
  if (bc_dtype == 0)
    return k12::dispatch<TX, float>(x, xsb, xst, xsh, dt, dsb, dst, cum, B,
                                    C, bsb, bst, bsh, dy, dS, b, s, nc, q, h,
                                    p, n, shared, dcum_row, dcum_col, elast,
                                    dc_head, db_head, dx, ddt, dcum, dB, dC,
                                    st);
  if (bc_dtype == 1)
    return k12::dispatch<TX, __nv_bfloat16>(
        x, xsb, xst, xsh, dt, dsb, dst, cum, B, C, bsb, bst, bsh, dy, dS, b,
        s, nc, q, h, p, n, shared, dcum_row, dcum_col, elast, dc_head,
        db_head, dx, ddt, dcum, dB, dC, st);
  return (int)cudaErrorInvalidValue;
}
