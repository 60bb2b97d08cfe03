// K7 ssd_chunk, variant "tf32x3": the fp32-x pairs (fp32 x over fp32 or
// bf16 B / C) on the tensor cores.  ssd_chunk.cu's tardis_ssd_chunk
// dispatches here; the contract is that file's (y_intra (b, nc, q, h, p)
// and the chunk states S (b, nc, h, p, n), fp32; positions t >= s read as
// the chunk's zero padding; the exponential only where j <= i).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py: ssd_intra_chunk
// (_ssd_kernel) for an fp32 x, which ssd_chunk.cu's SIMT kernel ran
// before (training's forward).
//
// Bound on the H100.  Per (chunk, head) ~q^2 p / 2 + q p n multiply-adds
// (plus q^2 n / 2 for C.B once a chunk where the heads share B and C)
// over ~4 q (p + 2n) + 4 q p bytes: at zamba2's training shape the bytes
// (y_intra alone is 4 q p a (chunk, head)) and the products as three TF32
// products are within 15 % of each other.  fp32's tolerance (2e-4)
// forbids plain TF32, so every product x y runs as three TF32 products of
// a hi / lo split (OpTf32, tardis_hopper.cuh): x_lo y_hi + x_hi y_lo +
// x_hi y_hi on mma.sync m16n8k8 in fp32 accumulators, the small products
// first (K6's tf32x3 and K10's arithmetic).  A bf16 B or C value widened
// to fp32 has a zero lo part: the same code, exact.
//
// Design.  One CTA per (b, chunk, group of heads): hpc heads where the
// heads share B and C (head stride 0), one head otherwise; 8 warps.
// * C.B^T is formed ONCE per CTA and kept across its heads: the lower
//   triangle of q/16 x q/16 blocks of 16 x 16, each stored as its warp's
//   fp32 C fragments in lane order (8 floats a lane as two float4 of
//   consecutive lanes, read back by whichever warp takes the block: no
//   bank conflicts, no layout change) -- 136 KB at q = 256.  Re-forming it per head (as the
//   bf16 variant does from its bf16 B / C tiles) would cost each head
//   another q^2 n / 2 products, 2/3 of its own work at n = 64; keeping it
//   costs the shared memory that an fp32 copy of B and C would need
//   (2 q n * 4 bytes: 128 KB at n = 64, 256 KB at n = 128, which does not
//   fit), so C.B^T is formed before the first head with B's rows staged
//   by 16-byte cp.async into the x region (all of them where n <= 64,
//   64-row blocks double-buffered at n = 128) and C's rows of the strip a
//   warp works on held in registers; the states' products read B's
//   fragments from global memory (L2), four k-steps' loads in flight.
// * Per head: x (q x p fp32) is staged by 16-byte cp.async into rows at
//   OpTf32::pitch (4 mod 8 words: conflict-free fragment loads), with
//   cum, dt and w_j = exp(cum_last - cum_j) dt_j.
// * y: warp u takes the 16-row strips u and q/16 - 1 - u, so every warp
//   does the same triangular work.  Per block (i-strip, j-block <= it) it
//   reads C.B^T's fragments, folds the decay and dt_j into M'_ij = cb_ij
//   exp(cum_i - cum_j) dt_j (the exponential only where j <= i) and feeds
//   M' as A fragments (OpTf32::a_from_c: M' never leaves registers)
//   against x's rows (OpTf32::load_b).
// * S^T = B^T (w o x): 16 rows of n a warp unit, B's fragments from global
//   memory (w folded into x's), every p column; where n <= 64 the j range
//   is split in two halves so that all 8 warps work, the second half's
//   partial added to the first's in shared memory (a fixed order).  The
//   states are computed before y, so that the exchange's barrier is hidden
//   behind y's work.
// No atomics: a run replays bit for bit.  (ssd_chunk_tf32_ref in ref.py
// is this arithmetic in PyTorch.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tardis_hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kP = 64;                    // p at most
constexpr int kPT = kP / 8;               // 8-wide p tiles
constexpr int kLdx = OpTf32::pitch(kP);   // x rows: 68 floats
constexpr int kXchg = 4 * 32 * kP / 2;    // the states' exchange (floats)

struct Args {
  const float* x;
  long long xsb, xst, xsh;
  const float* dt;
  long long dsb, dst;
  const float* cum;
  const void *B, *C;
  long long bsb, bst, bsh;
  int s, nc, q, h, p, n, hpc;
  int bc_vec;                              // B / C by 16-byte cp.async
  float *y, *S;
};

__host__ __device__ constexpr int cb_blocks(int q) {
  return (q / 16) * (q / 16 + 1) / 2;
}
// the x tile (per head) and, before the first head, B's rows at a pitch
// of n + 4 (4 mod 8 words) for C.B^T: all of them where n <= 64, else
// 64-row blocks (two in flight at q = 256)
__host__ __device__ constexpr int region_floats(int q, int nmax) {
  return q * kLdx > 64 * OpTf32::pitch(nmax) ? q * kLdx
                                             : 64 * OpTf32::pitch(nmax);
}
// bytes of dynamic shared memory: C.B^T's blocks, the x region, cum / dt /
// w and the states' exchange (228,352 at q = 256)
__host__ __device__ constexpr size_t smem_bytes(int q, int nmax) {
  return sizeof(float) * (static_cast<size_t>(cb_blocks(q)) * 256 +
                          region_floats(q, nmax) + 3 * q + kXchg);
}

// NMAX: n at most (64 or 128); TBC: B and C's type (fp32, or bf16 widened)
template <typename TBC, int NMAX>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_tf32(const Args a) {
  constexpr int NK = NMAX / 8;             // 8-wide k-steps of n
  constexpr int JSPLIT = NMAX <= 64 ? 2 : 1;
  constexpr int LDC = OpTf32::pitch(NMAX);  // B's rows for C.B^T
  extern __shared__ __align__(16) float smem[];
  const int q = a.q, h = a.h, p = a.p, n = a.n;
  float* cbs = smem;                                   // C.B^T blocks
  float* xs = cbs + static_cast<size_t>(cb_blocks(q)) * 256;  // [j][p]
  float* cum_s = xs + region_floats(q, NMAX);
  float* dt_s = cum_s + q;
  float* w_s = dt_s + q;
  float* xchg = w_s + q;                               // [strip][32][lane]

  const int bc = blockIdx.x;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int h0 = blockIdx.y * a.hpc, h1 = min(h, h0 + a.hpc);
  const long long t_base = static_cast<long long>(c) * q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ns = q / 16, nk = n / 8, pt_live = p / 8;
  const float* cum_bc = a.cum + static_cast<long long>(bc) * q * h;
  // B and C of the CTA's heads (head stride 0 where they share them)
  const TBC* Bb = static_cast<const TBC*>(a.B) + bi * a.bsb + h0 * a.bsh;
  const TBC* Cb = static_cast<const TBC*>(a.C) + bi * a.bsb + h0 * a.bsh;
  // B or C at chunk position j, column k: 0 past s
  auto bcv = [&](const TBC* m, int j, int k) -> float {
    const long long t = t_base + j;
    return t < a.s ? ldf(m + t * a.bst + k) : 0.f;
  };

  // ---- C.B^T: the lower triangle's 16 x 16 blocks.  Warp u takes the
  // strips u and ns - 1 - u (17 blocks each at q = 256), one after the
  // other: the strip's C rows into registers from global memory, all
  // loads in flight at once; B's rows staged into the x region by
  // cp.async -- every row once where they fit (n <= 64), else 64-row
  // blocks streamed past each strip, the next one in flight where two
  // fit ----
  const bool has = warp < (ns + 1) / 2;
  const int sts[2] = {warp, ns - 1 - warp};
  const long long live_q = min(static_cast<long long>(q), a.s - t_base);
  const bool whole = q * LDC <= region_floats(q, NMAX);
  const int rb = whole ? q : 64;           // B's rows a stage
  const int nbl = (q + rb - 1) / rb;       // stages a strip
  const int nbuf = !whole && 2 * 64 * LDC <= region_floats(q, NMAX) ? 2 : 1;
  auto stage_b = [&](int k) {              // stage k's rows (k % nbl) * rb
    if (whole && k > 0) return;            // .. into buffer k % nbuf
    float* dst = xs + (k % nbuf) * rb * LDC;
    for (int r = 0; r < rb; r += 64) {
      const long long j = static_cast<long long>(k % nbl) * rb + r;
      const int nv = static_cast<int>(max(0LL, min(64LL, live_q - j)));
      stage<TBC, float, 64, kThreads>(dst + r * LDC, LDC,
                                      nv ? Bb + (t_base + j) * a.bst : Bb,
                                      a.bst, nv, n, a.bc_vec);
    }
  };
  stage_b(0);
  cp_async_commit();
  float ca[NK][4];                         // C's rows 16 st + grp (+ 8)
  for (int k = 0; k < 2 * nbl; ++k) {
    const int side = k / nbl, jp = (k % nbl) * rb;
    const int st = sts[side];
    const bool live = has && !(side && st == sts[0]);
    if (k % nbl == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (kk < nk) {
          const int r0 = st * 16 + grp, c0 = kk * 8 + tig;
          ca[kk][0] = bcv(Cb, r0, c0);
          ca[kk][1] = bcv(Cb, r0 + 8, c0);
          ca[kk][2] = bcv(Cb, r0, c0 + 4);
          ca[kk][3] = bcv(Cb, r0 + 8, c0 + 4);
        }
    }
    if (nbuf == 2) {
      if (k + 1 < 2 * nbl) stage_b(k + 1); // its buffer's readers are done
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // stage k's rows are in
    const float* bs = xs + (k % nbuf) * rb * LDC;
    for (int kj = jp / 16; live && kj <= st && kj < min(q, jp + rb) / 16;
         ++kj) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (kk < nk) {
          const OpTf32::A af = tf32_a(ca[kk][0], ca[kk][1], ca[kk][2],
                                      ca[kk][3]);
          OpTf32::B bf[2];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            bf[nb] = OpTf32::load_bt(bs, LDC, kj * 16 - jp + nb * 8, kk * 8);
          mma3<2>(acc, af, bf, 2);
        }
      float4* dst = reinterpret_cast<float4*>(
                        cbs + (st * (st + 1) / 2 + kj) * 256) + lane;
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[32] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
    __syncthreads();                       // stage k's readers are done
    if (nbuf == 1 && k + 1 < 2 * nbl) {
      stage_b(k + 1);
      cp_async_commit();
    }
  }

  const int n_strips = (n + 15) / 16;
  const int cpr = p / 4;                   // 16-byte chunks of an x row
  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();                       // C.B^T written; x, w free
    const float* xh = a.x + bi * a.xsb + hh * a.xsh;
    for (int e = tid; e < q * cpr; e += kThreads) {
      const int j = e / cpr, ch = e - j * cpr;
      const long long t = t_base + j;
      const bool ok = t < a.s;
      cp_async16(xs + j * kLdx + ch * 4, ok ? xh + t * a.xst + ch * 4 : xh,
                 ok);
    }
    cp_async_commit();
    for (int j = tid; j < q; j += kThreads) {
      const long long t = t_base + j;
      cum_s[j] = cum_bc[static_cast<long long>(j) * h + hh];
      dt_s[j] = t < a.s ? a.dt[bi * a.dsb + t * a.dst + hh] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int j = tid; j < q; j += kThreads)
      w_s[j] = ex2((cum_s[q - 1] - cum_s[j]) * kTardisLog2e) * dt_s[j];
    __syncthreads();
    float* sh = a.S + (static_cast<long long>(bc) * h + hh) * p * n;

    // ---- S^T = B^T (w o x): unit (n-strip, j part) of warp ---------------
    const int nstrip = warp % n_strips, part = warp / n_strips;
    const bool s_unit = part < JSPLIT;
    float sacc[kPT][4];
#pragma unroll
    for (int t = 0; t < kPT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[t][e] = 0.f;
    if (s_unit) {
      const int span = q / JSPLIT;         // a multiple of 8
      const int n0 = nstrip * 16 + grp, n1 = n0 + 8;
      const int end = (part + 1) * span;
      for (int j0 = part * span; j0 < end; j0 += 32) {
        // A (rows n, k = j in load_b's order: k = tig is row j0 + 2 tig,
        // k = tig + 4 row j0 + 2 tig + 1) of four k-steps: B's values from
        // global memory, all in flight before the first product
        float bv[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ja = j0 + 8 * u + 2 * tig;
          const bool live = j0 + 8 * u < end;
          bv[u][0] = live && n0 < n ? bcv(Bb, ja, n0) : 0.f;
          bv[u][1] = live && n1 < n ? bcv(Bb, ja, n1) : 0.f;
          bv[u][2] = live && n0 < n ? bcv(Bb, ja + 1, n0) : 0.f;
          bv[u][3] = live && n1 < n ? bcv(Bb, ja + 1, n1) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + 8 * u >= end) break;
          const int ja = j0 + 8 * u + 2 * tig;
          const OpTf32::A af = tf32_a(bv[u][0], bv[u][1], bv[u][2],
                                      bv[u][3]);
          const float wa = w_s[ja], wb = w_s[ja + 1];
          OpTf32::B bf[kPT];
#pragma unroll
          for (int t = 0; t < kPT; ++t)
            if (t < pt_live) {
              const float* xr = xs + ja * kLdx + t * 8 + grp;
              bf[t] = tf32_b(xr[0] * wa, xr[kLdx] * wb);
            }
          mma3<kPT>(sacc, af, bf, pt_live);
        }
      }
      if (JSPLIT == 2 && part == 1) {
#pragma unroll
        for (int t = 0; t < kPT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xchg[(nstrip * 32 + t * 4 + e) * 32 + lane] = sacc[t][e];
      }
    }

    // ---- y_intra: the strips u and ns - 1 - u of warp u ------------------
    for (int u = warp; u < (ns + 1) / 2; u += kWarps) {
      for (int side = 0; side < 2; ++side) {
        const int st = side ? ns - 1 - u : u;
        if (side && st == u) break;
        const int r0 = st * 16 + grp, r1 = r0 + 8;
        const float ci0 = cum_s[r0], ci1 = cum_s[r1];
        float acc[kPT][4];
#pragma unroll
        for (int t = 0; t < kPT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        for (int kj = 0; kj <= st; ++kj) {
          const int j0 = kj * 16;
          const float4* src = reinterpret_cast<const float4*>(
                                  cbs + (st * (st + 1) / 2 + kj) * 256) + lane;
          const float4 v0 = src[0], v1 = src[32];
          const float cb[2][4] = {{v0.x, v0.y, v0.z, v0.w},
                                  {v1.x, v1.y, v1.z, v1.w}};
          // M' = cb exp(cum_i - cum_j) dt_j where j <= i, else 0
          float m[2][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int j = j0 + nb * 8 + 2 * tig;
            const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
            const float d0 = dt_s[j], d1 = dt_s[j + 1];
            m[nb][0] = j <= r0 ? cb[nb][0] * ex2((ci0 - cj0) * kTardisLog2e)
                                     * d0 : 0.f;
            m[nb][1] = j + 1 <= r0 ? cb[nb][1] *
                                         ex2((ci0 - cj1) * kTardisLog2e) * d1
                                   : 0.f;
            m[nb][2] = j <= r1 ? cb[nb][2] * ex2((ci1 - cj0) * kTardisLog2e)
                                     * d0 : 0.f;
            m[nb][3] = j + 1 <= r1 ? cb[nb][3] *
                                         ex2((ci1 - cj1) * kTardisLog2e) * d1
                                   : 0.f;
          }
          // y += M' x: M' as A fragments, x's rows as B fragments
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const OpTf32::A af = OpTf32::a_from_c(m, kk);
            OpTf32::B bf[kPT];
#pragma unroll
            for (int t = 0; t < kPT; ++t)
              if (t < pt_live) bf[t] = OpTf32::load_b(xs, kLdx, j0 + kk * 8,
                                                      t * 8);
            mma3<kPT>(acc, af, bf, pt_live);
          }
        }
        float* y0 = a.y + ((static_cast<long long>(bc) * q + r0) * h + hh) *
                              p;
        float* y1 = y0 + 8LL * h * p;
#pragma unroll
        for (int t = 0; t < kPT; ++t)
          if (t < pt_live) {
            const int col = t * 8 + 2 * tig;
            *reinterpret_cast<float2*>(y0 + col) =
                make_float2(acc[t][0], acc[t][1]);
            *reinterpret_cast<float2*>(y1 + col) =
                make_float2(acc[t][2], acc[t][3]);
          }
      }
    }

    // ---- S: the first part plus the second (read back), stored ----------
    if (JSPLIT == 2) __syncthreads();
    if (s_unit && part == 0) {
      const int n0 = nstrip * 16 + grp, n1 = n0 + 8;
#pragma unroll
      for (int t = 0; t < kPT; ++t)
        if (t < pt_live) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = JSPLIT == 2
                       ? sacc[t][e] + xchg[(nstrip * 32 + t * 4 + e) * 32 +
                                           lane]
                       : sacc[t][e];
          const int pp = t * 8 + 2 * tig;  // rows n, columns p of S^T
          if (n0 < n) {
            sh[static_cast<long long>(pp) * n + n0] = v[0];
            sh[static_cast<long long>(pp + 1) * n + n0] = v[1];
          }
          if (n1 < n) {
            sh[static_cast<long long>(pp) * n + n1] = v[2];
            sh[static_cast<long long>(pp + 1) * n + n1] = v[3];
          }
        }
    }
  }
}

template <typename TBC, int NMAX>
int launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.q, NMAX);
  auto kern = ssd_chunk_tf32<TBC, NMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * a.nc, (a.h + a.hpc - 1) / a.hpc);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The tf32x3 variant of tardis_ssd_chunk (ssd_chunk.cu), which calls it
// with that function's arguments for an fp32 x (16-byte aligned, strides
// in multiples of 4 elements) over fp32 (bc_dtype 0) or bf16 (1) B / C,
// q a multiple of 16 up to 256, p <= 64 and n <= 128 multiples of 8;
// heads_per_cta heads a CTA (1 unless the heads share B and C).
int tardis_ssd_chunk_tf32(const void* x, long long xsb, long long xst,
                          long long xsh, const void* dt, long long dsb,
                          long long dst, const void* cum, const void* B,
                          const void* C, long long bsb, long long bst,
                          long long bsh, int b, int s, int nc, int q, int h,
                          int p, int n, int bc_dtype, int heads_per_cta,
                          void* y, void* S, cudaStream_t stream) {
  if (q % 16 || q > 256 || p % 8 || p > kP || n % 8 || n > 128 ||
      heads_per_cta <= 0 || (bsh != 0 && heads_per_cta != 1) ||
      bc_dtype < 0 || bc_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if ((xsb | xst | xsh) % 4 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int bc_vec = bc_dtype == 0 && (bsb | bst | bsh) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const Args a{static_cast<const float*>(x), xsb, xst, xsh,
               static_cast<const float*>(dt), dsb, dst,
               static_cast<const float*>(cum), B, C, bsb, bst, bsh, s, nc, q,
               h, p, n, heads_per_cta, bc_vec, static_cast<float*>(y),
               static_cast<float*>(S)};
  if (bc_dtype == 0)
    return n <= 64 ? launch<float, 64>(a, b, stream)
                   : launch<float, 128>(a, b, stream);
  return n <= 64 ? launch<__nv_bfloat16, 64>(a, b, stream)
                 : launch<__nv_bfloat16, 128>(a, b, stream);
}
