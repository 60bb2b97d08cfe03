// K12 ssd_chunk_backward, variant "tf32x3": its kernels and launcher,
// shared by the two sources that instantiate them
// (ssd_scan/csrc/ssd_chunk_backward_tf32.cu for an fp32 x, with the C
// entry point and the finishing kernel; ssd_chunk_backward_tf32_bf16.cu
// for a bf16 x: two nvcc processes that build side by side).
//
// The closed form is ssd_chunk_backward.cu's.  Per (b, chunk, head), with
// xdt = x dt, cb = C B^T, L_ij = exp(cum_i - cum_j) for i >= j, M = cb o L,
// e_j = exp(cum_last - cum_j):
//   dxdt = M^T dy + e o (B dS^T);  dM = dy xdt^T (i >= j);  dcb = dM o L
//   dC = dcb B;  dB = dcb^T C + e o (xdt dS);  dcum from dM o M and e.
// Where one group serves every head (B and C at head stride 0),
// dC = (sum_h dcb_h) B and dB's cb part = (sum_h dcb_h)^T C: the n-wide
// products run once for a CTA's heads, after the heads' dcb are summed.
//
// Bound on the H100: operations (products at fp32 accuracy as three TF32
// products: K6's tf32x3, K10, K7's tf32x3).  Every product below runs on
// mma.sync m16n8k8 through OpTf32 (tardis_hopper.cuh), x_lo y_hi + x_hi
// y_lo + x_hi y_hi, the products of several accumulators issued in turns.
//
// Design.  One CTA per (b, chunk, 64-position j-block J, group of heads:
// hpc heads where B and C are shared, one otherwise), 8 warps, heaviest
// first (J = 0 walks the most i-blocks).  Warp w owns 16 rows j (w % 4)
// and 32 columns i (w / 4) of every 64 x 64 tile (I, J), I >= J, which it
// computes transposed (rows j, columns i) so that dxdt_j and dB_j, the
// sums over i, come out of fragments it holds.  Nothing q x q leaves the
// CTA; every sum runs in an order the shapes fix (no float atomics), so
// two calls are bit-identical.
// * B_J is staged once.  cb^T tiles (B_J C_I^T, K = n) are formed ONCE
//   for all the CTA's heads and kept in shared memory as the owning warp's
//   fp32 C fragments in lane order (16 KB a tile).
// * Per head: x_J, dS and the head's cum staged (where n <= 64 with the
//   first dy tile: dS fits the second dy buffer); the state terms first
//   -- B dS^T for the warp's rows and every other 8-wide tile of p (into
//   its dxdt partial and de_j), x dS for its rows and half of n (e_j
//   dt_j times it into the dB accumulator, summed over the heads in head
//   order) -- then the tiles I = J .. with dy_I double-buffered by
//   16-byte cp.async: dM^T = xdt_J dy_I^T (K = p), L^T from cum, M^T =
//   cb^T o L^T, dcb^T = dM^T o L^T; dM o M's sums over i (-> dcum_j) in
//   registers and over j (-> dcum_i, a partial per J summed later)
//   through shared memory; D += dcb^T (the head sum, in shared memory);
//   dxdt_J += M^T dy_I with M^T fed back as A fragments
//   (OpTf32::a_from_c).  The two warps of a row strip swap halves of their
//   dxdt partials once a head; dx, ddt, dcum's column part and the
//   block's share of dcum_last are written.
// * After the heads: dB_J += D^T C_I from D's fragments, and dC_I's
//   share from J, D B_J, with D laid out row-major once a tile.  dB_J and
//   the dC shares go to scratch as one partial a group (a group's sum
//   over the chunk's J-blocks for dC); the finishing kernel sums them in
//   group order (and J order), and dcum's parts.
// Scratch: dC shares (b, nc, groups, q / 64, q, n) -- only rows at or
// after J are written or read -- and dB partials (b, nc, groups, q, n): at
// the training shapes ~30 % (zamba2: 8 groups of 10 heads) and ~15 %
// (mamba2: 2 groups of 12) of the bytes that per-head dB / dC partials
// (b, s, h, n) would move.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tardis_hopper.cuh"

namespace k12t {

// the operands, scratch and outputs of one call (a named type: the two
// sources pass it to each other)
struct Args {
  const void* x;
  long long xsb, xst, xsh;
  const float* dt;
  long long dsb, dst;
  const float* cum;
  const void *B, *C;
  long long bsb, bst, bsh;
  const float *dy, *dS;       // (b, nc, q, h, p), (b, nc, h, p, n)
  int b, s, nc, q, h, p, n, hpc, groups;
  int x_vec, bc_vec, dy_vec;  // 16-byte staging allowed
  float* rowp;                // (b, nc, q / 64, q, h): dcum_i's parts by J
  float* colp;                // (b, nc, q, h): dcum_j's column part
  float* elast;               // (b, nc, h, q / 64): dcum_last's shares
  float* dcp;                 // (b, nc, groups, q / 64, q, n)
  float* dbp;                 // (b, nc, groups, q, n)
  void* dx;                   // (b, s, h, p) in x's dtype
  float* ddt;                 // (b, s, h)
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;                     // tile edge: positions i and j
constexpr int kP = 64;                     // p at most
constexpr int kLdp = OpTf32::pitch(kP);    // x, dy rows: 68 floats
constexpr int kLdd = 72;                   // D row-major: 8 mod 32 words
constexpr int kFrag = kWarps * 32 * 16;    // one tile's fragments (floats)

__host__ __device__ constexpr int ldn(int nmax) {
  return OpTf32::pitch(nmax);
}
// dynamic shared memory (floats): cb^T and D tiles, B_J, x_J, the staging
// region (dy double buffer; C_I, dS, D row-major, the dxdt swap), small
// arrays
__host__ __device__ constexpr int stage_floats(int nmax) {
  return 2 * kT * kLdp > kT * ldn(nmax) ? 2 * kT * kLdp : kT * ldn(nmax);
}
constexpr int kSmall = 4 * kT + kT + 2 * 4 * kT + 3 * 2 * kT + 2;
__host__ __device__ constexpr size_t smem_bytes(int nmax, int q) {
  return sizeof(float) *
         (static_cast<size_t>(2 * (q / kT)) * kFrag + kT * ldn(nmax) +
          kT * kLdp + stage_floats(nmax) + kSmall);
}

// B (8 x 8)[k][n] = t[(k0 + k) * ld + n0 + n] in the natural k order
// (load_a's and load_bt's): the tile's rows are B's rows
__device__ __forceinline__ OpTf32::B load_bk(const float* t, int ld, int k0,
                                             int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = t + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  return tf32_b(p[0], p[4 * ld]);
}
// A (16 x 8) = t[r][k0 + k] in a_from_c's / load_b's k order (k = tig is
// column k0 + 2 tig, k = tig + 4 column k0 + 2 tig + 1), one 8-byte load a
// row: conflict-free at a pitch of 8 mod 32 words
__device__ __forceinline__ OpTf32::A load_a_pairs(const float* t, int ld,
                                                  int k0) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const float2 u = *reinterpret_cast<const float2*>(t + grp * ld + k0 +
                                                    2 * tig);
  const float2 v = *reinterpret_cast<const float2*>(t + (grp + 8) * ld + k0 +
                                                    2 * tig);
  OpTf32::A a;
  split_tf32(u.x, a.hi[0], a.lo[0]);
  split_tf32(v.x, a.hi[1], a.lo[1]);
  split_tf32(u.y, a.hi[2], a.lo[2]);
  split_tf32(v.y, a.hi[3], a.lo[3]);
  return a;
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = 0.f;
}

// a warp's 4 x 4 fragment floats at its slot of a tile (lane order: four
// float4 of consecutive lanes, conflict-free)
__device__ __forceinline__ void frag_store(float* slot,
                                           const float (&v)[4][4]) {
  float4* p = reinterpret_cast<float4*>(slot) + (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    p[32 * k] = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
}
__device__ __forceinline__ void frag_load(const float* slot,
                                          float (&v)[4][4]) {
  const float4* p = reinterpret_cast<const float4*>(slot) +
                    (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 u = p[32 * k];
    v[k][0] = u.x;
    v[k][1] = u.y;
    v[k][2] = u.z;
    v[k][3] = u.w;
  }
}

// A warp owns half of p in the dxdt swap and the state terms: the 8-wide
// p tiles 2 t + IH.  The three steps that address the warp's own tiles or
// its partner's take IH as a template parameter (called as ih ? f<1> :
// f<0>), so that the dxdt partial is indexed by constants only (indexing
// a register array at run time would move it to local memory).
// dxa's own tiles = e_j B dS^T (bds: the warp's tiles in order)
template <int IH, int PT, int PH>
__device__ __forceinline__ void dxa_from_eterm(float (&dxa)[PT][4],
                                               const float (&bds)[PH][4],
                                               float e0, float e1) {
#pragma unroll
  for (int t = 0; t < PH; ++t) {
    dxa[2 * t + IH][0] = e0 * bds[t][0];
    dxa[2 * t + IH][1] = e0 * bds[t][1];
    dxa[2 * t + IH][2] = e1 * bds[t][2];
    dxa[2 * t + IH][3] = e1 * bds[t][3];
  }
}
// the partner's tiles of dxa into the warp's slot of the swap
// ([16][lane]: tile t's 4 values at rows 4 t ..)
template <int IH, int PT, int PH>
__device__ __forceinline__ void dxa_swap_out(const float (&dxa)[PT][4],
                                             float* slot) {
#pragma unroll
  for (int t = 0; t < PH; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) slot[(t * 4 + e) * 32] = dxa[2 * t + 1 - IH][e];
}
// the warp's own tiles: half 0's partial + half 1's (the partner's from
// its slot)
template <int IH, int PT, int PH>
__device__ __forceinline__ void dxa_own(const float (&dxa)[PT][4],
                                        const float* other,
                                        float (&v)[PH][4]) {
#pragma unroll
  for (int t = 0; t < PH; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float theirs = other[(t * 4 + e) * 32];
      v[t][e] = IH == 0 ? dxa[2 * t][e] + theirs : theirs + dxa[2 * t + 1][e];
    }
}

// the sum over the 8 rows of a fragment column (lane bits 2-4): a fixed
// butterfly
__device__ __forceinline__ float col_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

template <typename TX, typename TBC, int NMAX>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_tf32(const Args a) {
  constexpr int LDN = ldn(NMAX);
  constexpr int NK = NMAX / 8;             // k-steps of n
  constexpr int NH = NMAX / 16;            // 8-wide tiles of half of n
  constexpr int PT = kP / 8, PH = kP / 16;
  const int q = a.q, h = a.h, p = a.p, n = a.n;
  const int nblk = q / kT;
  extern __shared__ __align__(16) float smem[];
  float* cbt = smem;                       // [tile][warp] fragments
  float* dts = cbt + nblk * kFrag;         // D^T, the head sum, likewise
  float* bj = dts + nblk * kFrag;          // B_J [j][n]
  float* xj = bj + kT * LDN;               // x_J [j][p]
  float* stg = xj + kT * kLdp;             // staging
  float* cumq = stg + stage_floats(NMAX);  // the head's cum, q positions
  float* dtj = cumq + 4 * kT;
  float* isum = dtj + kT;                  // [buffer][j strip][i]
  float* red = isum + 2 * 4 * kT;          // [jsum, de, ddt][half][j]
  float* share = red + 3 * 2 * kT;         // [warp]: sums of de_j e_j

  // CTA -> (J, group, b * chunk), J = 0 (the most tiles) first
  const int n_bc = a.b * a.nc;
  const int bc = blockIdx.x % n_bc;
  const int g = (blockIdx.x / n_bc) % a.groups;
  const int J = blockIdx.x / (n_bc * a.groups);
  const int ntile = nblk - J;
  const int bi = bc / a.nc;
  const long long t_base = static_cast<long long>(bc - bi * a.nc) * q;
  const int jg = J * kT;                   // the block's first position
  const int h0 = g * a.hpc, h1 = min(h, h0 + a.hpc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int js = warp & 3, ih = warp >> 2;
  const int jr0 = js * 16 + grp, jr1 = jr0 + 8;   // the warp's rows j
  const int pk = p / 8, ph = p / 16, nh = n / 16;
  const float* cum_bc = a.cum + static_cast<long long>(bc) * q * h;
  const TBC* Bb = static_cast<const TBC*>(a.B) + bi * a.bsb + h0 * a.bsh;
  const TBC* Cb = static_cast<const TBC*>(a.C) + bi * a.bsb + h0 * a.bsh;
  // live rows of a 64-row block from chunk position r (the rest zero)
  auto live_rows = [&](int r) -> int {
    const long long v = a.s - (t_base + r);
    return v <= 0 ? 0 : (v >= kT ? kT : static_cast<int>(v));
  };
  auto stage_bc = [&](float* dst, const TBC* m, int r) {
    const int nv = live_rows(r);
    stage<TBC, float, kT, kThreads>(dst, LDN,
                                    nv ? m + (t_base + r) * a.bst : m,
                                    a.bst, nv, n, a.bc_vec);
  };

  stage_bc(bj, Bb, jg);
  cp_async_commit();

  // ---- cb^T tiles (B_J C_I^T), once for the CTA's heads ------------------
  for (int t = 0; t < ntile; ++t) {
    stage_bc(stg, Cb, (J + t) * kT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[4][4];
    zero(acc);
    for (int kk = 0; kk < n / 8; ++kk) {
      const OpTf32::A af = OpTf32::load_a(bj + js * 16 * LDN, LDN, kk * 8);
      OpTf32::B bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt] = OpTf32::load_bt(stg, LDN, ih * 32 + nt * 8, kk * 8);
      mma3<4>(acc, af, bf, 4);
    }
    frag_store(cbt + (t * kWarps + warp) * 512, acc);
    __syncthreads();                       // stg free
  }

  float dbacc[NH][4];                      // dB_J: rows jr0 / jr1, n-half ih
  zero(dbacc);
  const TX* xb = static_cast<const TX*>(a.x) + bi * a.xsb;
  // where n <= 64, dS fits one dy buffer: it and the first dy tile come
  // in with x_J (else dS takes the staging region, the dy tile after it)
  float* dss = NMAX <= 64 ? stg + kT * kLdp : stg;
  const float* dyh0 = a.dy + static_cast<long long>(bc) * q * h * p;
  auto issue_dy = [&](int t, int hh) {
    const int ig = (J + t) * kT;
    stage<float, float, kT, kThreads>(
        stg + (t & 1) * kT * kLdp, kLdp,
        dyh0 + (static_cast<long long>(ig) * h + hh) * p,
        static_cast<long long>(h) * p, kT, p, a.dy_vec);
  };
  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();                       // the last head's readers done
    {
      const int nv = live_rows(jg);
      stage<TX, float, kT, kThreads>(
          xj, kLdp, nv ? xb + (t_base + jg) * a.xst + hh * a.xsh : xb, a.xst,
          nv, p, a.x_vec);
      stage<float, float, kP, kThreads>(
          dss, LDN, a.dS + (static_cast<long long>(bc) * h + hh) * p * n, n,
          p, n, a.dy_vec);
      if (NMAX <= 64) issue_dy(0, hh);
      cp_async_commit();
    }
    for (int i = jg + tid; i < q; i += kThreads)
      cumq[i] = cum_bc[static_cast<long long>(i) * h + hh];
    if (tid < kT) {
      const long long t = t_base + jg + tid;
      dtj[tid] = t < a.s ? a.dt[bi * a.dsb + t * a.dst + hh] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    const float cum_last = cumq[q - 1];
    const float dt0 = dtj[jr0], dt1 = dtj[jr1];
    const float cj0 = cumq[jg + jr0], cj1 = cumq[jg + jr1];
    const float e0 = ex2((cum_last - cj0) * kTardisLog2e);
    const float e1 = ex2((cum_last - cj1) * kTardisLog2e);

    // ---- the state terms: B dS^T (p tiles 2 t + ih), x dS (n-half ih) ---
    float dxa[PT][4];                      // dxdt partial, every p column
    zero(dxa);
    float de0 = 0.f, de1 = 0.f;
    {
      float bds[PH][4];
      zero(bds);
      for (int kk = 0; kk < n / 8; ++kk) {
        const OpTf32::A af = OpTf32::load_a(bj + js * 16 * LDN, LDN, kk * 8);
        OpTf32::B bf[PH];
#pragma unroll
        for (int t = 0; t < PH; ++t)
          if (t < ph)
            bf[t] = OpTf32::load_bt(dss, LDN, (2 * t + ih) * 8, kk * 8);
        mma3<PH>(bds, af, bf, ph);
      }
#pragma unroll
      for (int t = 0; t < PH; ++t)
        if (t < ph) {
          const int col = (2 * t + ih) * 8 + 2 * tig;
          const float* x0 = xj + jr0 * kLdp + col;
          const float* x1 = xj + jr1 * kLdp + col;
          de0 += x0[0] * bds[t][0] + x0[1] * bds[t][1];
          de1 += x1[0] * bds[t][2] + x1[1] * bds[t][3];
        }
      if (ih)
        dxa_from_eterm<1>(dxa, bds, e0, e1);
      else
        dxa_from_eterm<0>(dxa, bds, e0, e1);
      de0 = quad_sum(de0) * dt0;
      de1 = quad_sum(de1) * dt1;
      float xds[NH][4];
      zero(xds);
      for (int kk = 0; kk < pk; ++kk) {
        const OpTf32::A af = OpTf32::load_a(xj + js * 16 * kLdp, kLdp,
                                            kk * 8);
        OpTf32::B bf[NH];
#pragma unroll
        for (int t = 0; t < NH; ++t)
          if (t < nh) bf[t] = load_bk(dss, LDN, kk * 8, ih * (n / 2) + t * 8);
        mma3<NH>(xds, af, bf, nh);
      }
      const float f0 = e0 * dt0, f1 = e1 * dt1;
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        dbacc[t][0] += f0 * xds[t][0];
        dbacc[t][1] += f0 * xds[t][1];
        dbacc[t][2] += f1 * xds[t][2];
        dbacc[t][3] += f1 * xds[t][3];
      }
    }
    float jsum0 = 0.f, jsum1 = 0.f;        // dM o M over i, rows jr0 / jr1
    __syncthreads();                       // dS read: stg takes dy

    if (NMAX > 64) issue_dy(0, hh);
    cp_async_commit();
    for (int t = 0; t < ntile; ++t) {
      const int buf = t & 1, ig = (J + t) * kT;
      if (t + 1 < ntile) issue_dy(t + 1, hh);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                     // tile t's dy and cum_I are in
      const float* dys = stg + buf * kT * kLdp;
      const float* ci = cumq + ig;
      // dM^T = xdt_J dy_I^T: rows j, columns i of the warp's half (K = p)
      float dm[4][4];
      zero(dm);
      for (int kk = 0; kk < pk; ++kk) {
        const OpTf32::A af = OpTf32::load_a(xj + js * 16 * kLdp, kLdp,
                                            kk * 8);
        OpTf32::B bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bf[nt] = OpTf32::load_bt(dys, kLdp, ih * 32 + nt * 8, kk * 8);
        mma3<4>(dm, af, bf, 4);
      }
      float cb[4][4], dsum[4][4];
      frag_load(cbt + (t * kWarps + warp) * 512, cb);
      float* dslot = dts + (t * kWarps + warp) * 512;
      if (hh == h0)
        zero(dsum);
      else
        frag_load(dslot, dsum);
      float ipart[4][2];                   // dM o M over the rows, by column
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        ipart[nt][0] = ipart[nt][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = ih * 32 + nt * 8 + 2 * tig + (e & 1);
          const int jl = e < 2 ? jr0 : jr1;
          // L^T: the exponential only where j <= i (on the diagonal tile)
          const float l = (t > 0 || jl <= il)
              ? ex2((ci[il] - (e < 2 ? cj0 : cj1)) * kTardisLog2e) : 0.f;
          const float dmv = dm[nt][e] * (e < 2 ? dt0 : dt1);
          const float dcb = dmv * l;
          const float prod = dcb * cb[nt][e];
          dm[nt][e] = cb[nt][e] * l;       // M^T
          dsum[nt][e] += dcb;
          ipart[nt][e & 1] += prod;
          if (e < 2)
            jsum0 += prod;
          else
            jsum1 += prod;
        }
      }
      frag_store(dslot, dsum);
      // dM o M summed over the tile's rows j: the 8 rows of each fragment
      // column, then the four row strips in order (after the barrier)
      float* is = isum + (buf * 4 + js) * kT;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = col_sum8(ipart[nt][e]);
          if (grp == 0) is[ih * 32 + nt * 8 + 2 * tig + e] = v;
        }
      // dxdt_J += M^T dy_I over the warp's 32 columns i
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const OpTf32::A af = OpTf32::a_from_c(dm, kk);
        OpTf32::B bf[PT];
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          if (pt < pk)
            bf[pt] = OpTf32::load_b(dys, kLdp, ih * 32 + kk * 8, pt * 8);
        mma3<PT>(dxa, af, bf, pk);
      }
      __syncthreads();                     // the buffer's readers are done
      if (tid < kT) {
        const float* s4 = isum + buf * 4 * kT + tid;
        a.rowp[((static_cast<long long>(bc) * nblk + J) * q + ig + tid) * h +
               hh] = ((s4[0] + s4[kT]) + s4[2 * kT]) + s4[3 * kT];
      }
    }

    // ---- swap halves of the dxdt partials; dx, ddt, dcum's column part ---
    float* xchg = stg;                     // [warp][16][lane]
    if (ih)
      dxa_swap_out<1, PT, PH>(dxa, xchg + warp * 16 * 32 + lane);
    else
      dxa_swap_out<0, PT, PH>(dxa, xchg + warp * 16 * 32 + lane);
    jsum0 = quad_sum(jsum0);
    jsum1 = quad_sum(jsum1);
    if (tig == 0) {
      red[ih * kT + jr0] = jsum0;
      red[ih * kT + jr1] = jsum1;
      red[(2 + ih) * kT + jr0] = de0;
      red[(2 + ih) * kT + jr1] = de1;
    }
    __syncthreads();
    const float* other = xchg + (warp ^ 4) * 16 * 32 + lane;
    float own[PH][4];                      // dxdt, the warp's p tiles
    if (ih)
      dxa_own<1>(dxa, other, own);
    else
      dxa_own<0>(dxa, other, own);
    float dd0 = 0.f, dd1 = 0.f;
    const long long t0 = t_base + jg + jr0, t1 = t0 + 8;
    TX* dxb = static_cast<TX*>(a.dx);
#pragma unroll
    for (int t = 0; t < PH; ++t)
      if (t < ph) {
        const int col = (2 * t + ih) * 8 + 2 * tig;
        const float* v = own[t];
        dd0 += v[0] * xj[jr0 * kLdp + col] + v[1] * xj[jr0 * kLdp + col + 1];
        dd1 += v[2] * xj[jr1 * kLdp + col] + v[3] * xj[jr1 * kLdp + col + 1];
        if (t0 < a.s) {
          TX* o = dxb + ((bi * static_cast<long long>(a.s) + t0) * h + hh) *
                            p + col;
          o[0] = from_f32<TX>(v[0] * dt0);
          o[1] = from_f32<TX>(v[1] * dt0);
        }
        if (t1 < a.s) {
          TX* o = dxb + ((bi * static_cast<long long>(a.s) + t1) * h + hh) *
                            p + col;
          o[0] = from_f32<TX>(v[2] * dt1);
          o[1] = from_f32<TX>(v[3] * dt1);
        }
      }
    dd0 = quad_sum(dd0);
    dd1 = quad_sum(dd1);
    if (tig == 0) {
      red[(4 + ih) * kT + jr0] = dd0;
      red[(4 + ih) * kT + jr1] = dd1;
    }
    __syncthreads();
    if (tid < kT) {                        // warps 0 and 1
      const int j = jg + tid;
      const long long t = t_base + j;
      const float jsum = red[tid] + red[kT + tid];
      const float de = red[2 * kT + tid] + red[3 * kT + tid];
      const float e = ex2((cum_last - cumq[j]) * kTardisLog2e);
      a.colp[(static_cast<long long>(bc) * q + j) * h + hh] = -jsum - de * e;
      if (t < a.s)
        a.ddt[(bi * static_cast<long long>(a.s) + t) * h + hh] =
            red[4 * kT + tid] + red[5 * kT + tid];
      float v = de * e;                    // the block's dcum_last share:
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)    // a fixed butterfly a warp
        v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0) share[warp] = v;
    }
    __syncthreads();
    if (tid == 0)
      a.elast[(static_cast<long long>(bc) * h + hh) * nblk + J] =
          share[0] + share[1];
  }

  // ---- the head-summed products: dB_J += D^T C_I, dC_I's share D B_J ------
  float* dcp_g = a.dcp + (static_cast<long long>(bc) * a.groups + g) *
                             nblk * q * n;
  for (int t = 0; t < ntile; ++t) {
    const int ig = (J + t) * kT;
    __syncthreads();                       // stg free
    stage_bc(stg, Cb, ig);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // dB_J (rows j, n-half ih) over the tile's 64 columns i: D^T's
    // fragments of both halves of the row strip
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d[4][4];
      frag_load(dts + (t * kWarps + js + 4 * half) * 512, d);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const OpTf32::A af = OpTf32::a_from_c(d, kk);
        OpTf32::B bf[NH];
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
          if (nt < nh)
            bf[nt] = OpTf32::load_b(stg, LDN, half * 32 + kk * 8,
                                    ih * (n / 2) + nt * 8);
        mma3<NH>(dbacc, af, bf, nh);
      }
    }
    __syncthreads();                       // C_I read: stg takes D
    float* dr = stg;                       // D [i][j] at kLdd
    {
      float d[4][4];
      frag_load(dts + (t * kWarps + warp) * 512, d);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dr[(ih * 32 + nt * 8 + 2 * tig + (e & 1)) * kLdd +
             (e < 2 ? jr0 : jr1)] = d[nt][e];
    }
    __syncthreads();
    // dC_I's share: rows i (strip js), n-half ih, K = the block's 64 j
    float dc[NH][4];
    zero(dc);
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const OpTf32::A af = load_a_pairs(dr + js * 16 * kLdd, kLdd, kk * 8);
      OpTf32::B bf[NH];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
        if (nt < nh)
          bf[nt] = OpTf32::load_b(bj, LDN, kk * 8, ih * (n / 2) + nt * 8);
      mma3<NH>(dc, af, bf, nh);
    }
    float* o = dcp_g + (static_cast<long long>(J) * q + ig + js * 16 + grp) *
                           n;
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
      if (nt < nh) {
        const int col = ih * (n / 2) + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(o + col) = make_float2(dc[nt][0],
                                                          dc[nt][1]);
        *reinterpret_cast<float2*>(o + 8LL * n + col) =
            make_float2(dc[nt][2], dc[nt][3]);
      }
  }
  float* o = a.dbp + ((static_cast<long long>(bc) * a.groups + g) * q + jg +
                      jr0) * n;
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
    if (nt < nh) {
      const int col = ih * (n / 2) + nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(o + col) = make_float2(dbacc[nt][0],
                                                        dbacc[nt][1]);
      *reinterpret_cast<float2*>(o + 8LL * n + col) =
          make_float2(dbacc[nt][2], dbacc[nt][3]);
    }
}

template <typename TX, typename TBC, int NMAX>
int launch(const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes(NMAX, a.q);
  auto kern = ssd_bwd_tf32<TX, TBC, NMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ctas = (a.q / kT) * a.groups * a.b * a.nc;
  kern<<<ctas, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace k12t

namespace {
// the main kernel for an x of type TX: B / C fp32 (bc_dtype 0) or bf16
// (1), n <= 64 or <= 128
template <typename TX>
int k12t_for_x(const k12t::Args& a, int bc_dtype, cudaStream_t st) {
  if (bc_dtype == 0)
    return a.n <= 64 ? k12t::launch<TX, float, 64>(a, st)
                     : k12t::launch<TX, float, 128>(a, st);
  if (bc_dtype == 1)
    return a.n <= 64 ? k12t::launch<TX, __nv_bfloat16, 64>(a, st)
                     : k12t::launch<TX, __nv_bfloat16, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}
}  // namespace
