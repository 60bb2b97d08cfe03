// Device helpers shared by the port's tensor-core kernels (K4-K7, K10,
// K12):
// asynchronous 16-byte copies, bf16 packing, mma.sync m16n8k16 and
// ldmatrix, the 16-byte-chunk swizzle of shared-memory rows, quad
// reductions, the three-part bf16 split of an fp32 operand, fp32 products
// as three TF32 products of a hi / lo split (OpTf32), and the
// split-position bf16 flash-decode of K4 and K5: one warp's 16-position
// stage and the merge across the warps of a CTA and the CTAs of a
// thread-block cluster.
//
// Each kernel source includes this header (the build passes -I for this
// directory); everything sits in an anonymous namespace, so each
// translation unit keeps its own copy.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace tardis_cg = cooperative_groups;

constexpr float kTardisNegInf = -1e30f;
constexpr float kTardisLog2e = 1.4426950408889634f;
constexpr int kTardisMaxSplit = 8;  // CTAs of a cluster: the portable size

// 2^x in one MUFU.EX2 (exp2f adds range checks around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two bf16 at consecutive addresses as one 32-bit fragment register
__device__ __forceinline__ unsigned pack_pair(const __nv_bfloat16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
         (static_cast<unsigned>(__bfloat16_as_ushort(p[1])) << 16);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// (lo, hi) as three bf16 pairs whose sums are lo and hi to fp32's 24
// significant bits (8 + 8 + 8): a product of each part with a bf16 value is
// exact in fp32, so three mma.sync passes give the fp32 factor's products.
__device__ __forceinline__ void split3(float lo, float hi,
                                       unsigned (&part)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    part[k] = pack_bf16(lo, hi);
    lo -= bf16_lo(part[k]);
    hi -= bf16_hi(part[k]);
  }
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16);
// a's rows 8-15 zero (a1 = a3 = 0)
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// ... with all 16 rows of a: a0 (rows 0-7, k 0-7), a1 (rows 8-15, k 0-7),
// a2 (rows 0-7, k 8-15), a3 (rows 8-15, k 8-15)
__device__ __forceinline__ void mma_bf16_16(float (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8 x 8 bf16 matrices from shared memory: thread t gives the row
// address of matrix t / 8 and receives, of matrix i in r[i], the elements
// (t / 4, 2 (t % 4)) and (t / 4, 2 (t % 4) + 1) -- transposed with .trans
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// the 16-byte chunk c of row r in a swizzled row of `pitch` bytes: eight
// rows' chunk c fall in eight different bank groups, so ldmatrix reads a
// column of chunks without conflicts
__device__ __forceinline__ int swz(int r, int c, int pitch) {
  return r * pitch + (((c & ~7) | ((c ^ r) & 7)) << 4);
}
// bytes a swizzled row of `cols` bf16 takes: whole 128-byte atoms
__host__ __device__ constexpr int swz_pitch(int cols) {
  return (cols + 63) / 64 * 128;
}

// max / sum over the 4 lanes that share a fragment row (lane bits 0-1)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}

// ---- fp32 products on the TF32 tensor cores (K6's tf32x3 variant, K10) -----

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
// cvt.rna's rounding for a finite x, in two integer operations -- cvt.rna
// itself compiles to a longer sequence that also handles NaN and inf),
// lo = x - hi exactly (|lo| <= 2^-11 |x|), handed to the mma as it is: the
// mma reads its top 19 bits, within 2^-10 |lo| of it.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8, fp32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one warp's products, for lane (grp = lane / 4, tig =
// lane % 4).  A tile `t` is row-major in shared memory at a pitch of `ld`
// elements.  load_a: A (16 x KS) = t[r][k0 + k] for the warp's 16 rows
// (t points at its row 0).  load_bt: B (KS x 8)[k][n] = t[n0 + n][k0 + k]
// (the tile's rows are B's columns: K for Q.K^T).  load_b: B (KS x 8)[k][n]
// = t[k0 + k][n0 + n] (the tile's rows are B's rows: K for dS.K), its k in
// the order a_from_c leaves.  a_from_c: the A fragment of k-step kk from
// the fp32 accumulators c of the 8-column n tiles of a 16-row product.
struct OpTf32 {
  using TS = float;
  static constexpr int KS = 8;
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned hi[2], lo[2]; };
  __host__ __device__ static constexpr int pitch(int dh) {
    return (dh + 7) / 8 * 8 + 4;
  }
  __device__ static A load_a(const float* t, int ld, int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const float* p = t + grp * ld + k0 + tig;
    A a;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
    return a;
  }
  __device__ static B load_bt(const float* t, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const float* p = t + (n0 + grp) * ld + k0 + tig;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[4], b.hi[1], b.lo[1]);
    return b;
  }
  // k = tig holds row 2 tig, k = tig + 4 row 2 tig + 1 (a_from_c's order)
  __device__ static B load_b(const float* t, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const float* p = t + (k0 + 2 * tig) * ld + n0 + grp;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[ld], b.hi[1], b.lo[1]);
    return b;
  }
  // c[kk] holds (grp, 2 tig + e) in c[kk][e] and (grp + 8, ...) in
  // c[kk][2 + e]: column 2 tig becomes k = tig, 2 tig + 1 k = tig + 4
  template <int N>
  __device__ static A a_from_c(const float (&c)[N][4], int kk) {
    A a;
    split_tf32(c[kk][0], a.hi[0], a.lo[0]);
    split_tf32(c[kk][2], a.hi[1], a.lo[1]);
    split_tf32(c[kk][1], a.hi[2], a.lo[2]);
    split_tf32(c[kk][3], a.hi[3], a.lo[3]);
    return a;
  }
  // the small products first
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
};

// OpTf32 fragments of raw fp32 values, split: A's in load_a's register
// order (rows grp, grp + 8 at k = tig, then at k = tig + 4), B's (k = tig,
// k = tig + 4)
__device__ __forceinline__ OpTf32::A tf32_a(float a0, float a1, float a2,
                                            float a3) {
  OpTf32::A a;
  split_tf32(a0, a.hi[0], a.lo[0]);
  split_tf32(a1, a.hi[1], a.lo[1]);
  split_tf32(a2, a.hi[2], a.lo[2]);
  split_tf32(a3, a.hi[3], a.lo[3]);
  return a;
}
__device__ __forceinline__ OpTf32::B tf32_b(float b0, float b1) {
  OpTf32::B b;
  split_tf32(b0, b.hi[0], b.lo[0]);
  split_tf32(b1, b.hi[1], b.lo[1]);
  return b;
}
// d[t] += a . b[t] for the tiles t < live as three TF32 products each (K7's
// and K12's tf32x3), the tiles' products issued in turns: lo.hi of each,
// then hi.lo, then hi.hi -- OpTf32::mma's order per accumulator, with
// independent mma.syncs between the dependent ones
template <int NT>
__device__ __forceinline__ void mma3(float (&d)[NT][4], const OpTf32::A& a,
                                     const OpTf32::B (&b)[NT], int live) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < live) mma_tf32(d[t], a.lo, b[t].hi[0], b[t].hi[1]);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < live) mma_tf32(d[t], a.hi, b[t].lo[0], b[t].lo[1]);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t < live) mma_tf32(d[t], a.hi, b[t].hi[0], b[t].hi[1]);
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Rows [0, n) of a (position, Dh) slice at row stride rs into NROWS rows
// of a shared tile at pitch ld; rows n.. are zero.  By 16-byte cp.async
// when the tile keeps the global type and `vec` (the wait is the
// caller's), else by plain loads (widening bf16 to fp32).
template <typename TG, typename TS, int NROWS, int NT>
__device__ __forceinline__ void stage(TS* dst, int ld, const TG* src,
                                      long long rs, int n, int dh,
                                      bool vec) {
  if constexpr (std::is_same<TG, TS>::value) {
    if (vec) {
      constexpr int E = 16 / sizeof(TS);
      const int cpr = dh / E;
      for (int x = threadIdx.x; x < NROWS * cpr; x += NT) {
        const int r = x / cpr, c = x - r * cpr;
        const bool ok = r < n;
        cp_async16(dst + r * ld + c * E, ok ? src + r * rs + c * E : src,
                   ok);
      }
      return;
    }
  }
  for (int x = threadIdx.x; x < NROWS * dh; x += NT) {
    const int r = x / dh, d = x - r * dh;
    dst[r * ld + d] = from_f32<TS>(r < n ? ldf(src + r * rs + d) : 0.f);
  }
}

// ---- the split-position bf16 decode (K4, K5) -------------------------------

constexpr int kDecodeStagePos = 16;    // positions in a warp's stage

// The ring of a CTA of W warps: each warp as many stages of a K and a V
// tile as fit in 12 KB (3 at Dh <= 64, so that two 8-warp CTAs fit an SM
// and a cluster of 8 lands on 4 SMs), at least 2
template <int DH, int W> struct DecodeRing {
  static constexpr int kPitch = swz_pitch(DH);               // bytes a row
  static constexpr int kTile = kDecodeStagePos * kPitch;     // K or V tile
  static constexpr int kStages =
      12288 / (2 * kTile) > 2 ? 12288 / (2 * kTile) : 2;
  static constexpr int kBytes = W * kStages * 2 * kTile;
};

// One warp's stage of 16 positions: S = Q.K^T with the G query heads as
// the rows (qa: Q's A fragments, row grp is head grp, rows 8-15 zero) from
// the stage's K tile `kt` ([position][d], rows swizzled), the online
// softmax of row grp in base 2 (scale2 = scale * log2(e); positions at or
// past `hi` masked, `base` the stage's first position), and O += P.V from
// the V tile `vt`, P entering exactly as three bf16 parts whose sum is
// the fp32 P.  (m, l, acc) are the lane's share of the warp's state.
template <int DH>
__device__ __forceinline__ void decode_stage(const unsigned char* kt,
                                             const unsigned char* vt,
                                             const unsigned (&qa)[DH / 16][2],
                                             int base, int hi, float scale2,
                                             float& m, float& l,
                                             float (&acc)[DH / 8][4]) {
  constexpr int KS = DH / 16, ND = DH / 8, PITCH = swz_pitch(DH);
  const int lane = threadIdx.x & 31, tig = lane & 3, mi = lane >> 3;
  // S: 16 head rows x 16 positions (two n-blocks)
  float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned bf[4];
    const int rr = (mi >> 1) * 8 + (lane & 7);
    ldmatrix_x4(bf, kt + swz(rr, ks * 2 + (mi & 1), PITCH));
    mma_bf16(sc[0], qa[ks][0], qa[ks][1], bf[0], bf[1]);
    mma_bf16(sc[1], qa[ks][0], qa[ks][1], bf[2], bf[3]);
  }
  // the online softmax of head grp (its row: sc[nb][0..1])
  float x[2][2], mx = m;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = base + nb * 8 + 2 * tig + e < hi;
      x[nb][e] = live ? sc[nb][e] * scale2 : kTardisNegInf;
      mx = fmaxf(mx, x[nb][e]);
    }
  mx = quad_max(mx);
  float p[2][2], sum = 0.f;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[nb][e] = x[nb][e] <= kTardisNegInf ? 0.f : ex2(x[nb][e] - mx);
      sum += p[nb][e];
    }
  const float alpha = ex2(m - mx);
  l = l * alpha + quad_sum(sum);
  m = mx;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] *= alpha;
    acc[nd][1] *= alpha;
  }
  // P as A fragments (a0 = positions 0-7, a2 = positions 8-15 of row grp)
  unsigned pa[2][3];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) split3(p[nb][0], p[nb][1], pa[nb]);
  // O += P.V: V's [position][d] rows as B fragments through ldmatrix.trans
#pragma unroll
  for (int nd = 0; nd < ND; nd += 2) {
    unsigned vf[4];
    ldmatrix_x4_trans(vf, vt + swz((mi & 1) * 8 + (lane & 7), nd + (mi >> 1),
                                   PITCH));
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      mma_bf16(acc[nd], pa[0][part], pa[1][part], vf[0], vf[1]);
      mma_bf16(acc[nd + 1], pa[0][part], pa[1][part], vf[2], vf[3]);
    }
  }
}

// ---- the split-position decode merge (K4, K5) ------------------------------

// Row stride (floats) of the warps' acc in the CTA merge: padded by 8 so
// that the 8 head rows a warp stores at once fall in different banks.
__host__ __device__ constexpr int acc_stride(int dh) { return dh + 8; }

// Bytes of dynamic shared memory before the partials: the ring, or the
// warps' (m, l, acc) of the CTA merge (which reuse it) where larger.
__host__ __device__ __forceinline__ size_t part_offset(size_t ring, int w,
                                                       int ng_max, int dh) {
  const size_t merge = sizeof(float) * w * ng_max * (2 + acc_stride(dh));
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}

// dynamic shared memory: the ring (or the merge) and n_split partials
inline size_t smem_bytes(size_t ring, int warps, int ng_max, int dh,
                         int n_split) {
  return part_offset(ring, warps, ng_max, dh) +
         sizeof(float) * ng_max * (2 + dh) * n_split;
}

// The pair's output from its CTAs, which form one thread-block cluster.
// Each CTA merges its warps' (m, l, acc) (wml [W][2][NG], wacc
// [W][NG][acc_stride(dh)] in shared memory) into its partial and stores
// it into its slot of EVERY CTA's `parts` ([n_split] slots of [2][NG]
// then [NG][dh], in shared memory beside them) through distributed shared
// memory; one cluster barrier (release / acquire) makes the stores
// visible; then each CTA folds its share of the output columns from its
// own shared memory and exits -- no remote loads, no second barrier.  No
// global scratch, no atomics, no second launch.  (Pulling the partials
// with remote loads between two barriers, or pushing them to rank 0 only
// behind an mbarrier, measured slower on the card.)  m is in base 2.
template <typename TQ, int NG, int W>
__device__ __forceinline__ void finish_cluster(const float* wml,
                                               const float* wacc,
                                               float* parts, int ng, int dh,
                                               TQ* __restrict__ ob) {
  tardis_cg::cluster_group cluster = tardis_cg::this_cluster();
  const int tid = threadIdx.x;
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ws = acc_stride(dh), slot = 2 * NG + NG * dh;
  for (int x = tid; x < ng * dh; x += W * 32) {
    const int gi = x / dh, d = x - gi * dh;
    float mx = kTardisNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wml[w * 2 * NG + gi]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = ex2(wml[w * 2 * NG + gi] - mx);
      ls += wml[(w * 2 + 1) * NG + gi] * f;
      as += wacc[(w * NG + gi) * ws + d] * f;
    }
    for (int r = 0; r < n_split; ++r) {
      float* dst = cluster.map_shared_rank(parts, r) + rank * slot;
      dst[2 * NG + x] = as;
      if (d == 0) {
        dst[gi] = mx;
        dst[NG + gi] = ls;
      }
    }
  }
  cluster.sync();
  for (int x = rank * W * 32 + tid; x < ng * dh; x += n_split * W * 32) {
    const int gi = x / dh;
    float mr[kTardisMaxSplit], lr[kTardisMaxSplit], ar[kTardisMaxSplit];
#pragma unroll
    for (int r = 0; r < kTardisMaxSplit; ++r) {
      mr[r] = kTardisNegInf;
      lr[r] = ar[r] = 0.f;
      if (r < n_split) {
        mr[r] = parts[r * slot + gi];
        lr[r] = parts[r * slot + NG + gi];
        ar[r] = parts[r * slot + 2 * NG + x];
      }
    }
    float mx = kTardisNegInf;
#pragma unroll
    for (int r = 0; r < kTardisMaxSplit; ++r) mx = fmaxf(mx, mr[r]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int r = 0; r < kTardisMaxSplit; ++r) {
      const float f = ex2(mr[r] - mx);
      ls += lr[r] * f;
      as += ar[r] * f;
    }
    ob[x] = from_f32<TQ>(as / fmaxf(ls, 1e-30f));
  }
}

// Launch `kern` over (pairs, n_split) CTAs in clusters of (1, n_split):
// one cluster per (b, kv head, head chunk) pair.
template <typename... Params, typename... Args>
int launch_cluster(void (*kern)(Params...), int pairs, int n_split,
                   int warps, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, n_split, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
