// K6 flash_prefill, variant "tf32x3": the fp32-q pairs (fp32 q over fp32
// K/V, and fp32 q over bf16 K/V) on the tensor cores, for Dh up to 128 in
// multiples of 8.  flash_prefill.cu's tardis_flash_prefill dispatches here;
// the contract is that file's (query i at kv position q_offset + i sees
// positions t < kv_len, and t <= q_offset + i under causal; the output is
// acc / max(l, 1e-30), 0 on a row with no live key; with a non-null lse,
// m * scale + log(l) per row, +inf on a dead row).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (_flash_kernel) for an fp32 q, which the SIMT
// kernel of flash_prefill.cu ran before.
//
// Bound on the H100: operations.  4 Dh flop a live (query, key, head);
// fp32's tolerance (2e-4) forbids plain TF32 products, and fp32 SIMT FMAs
// peak at 67 TFLOP/s.  Here every product x y runs as three TF32 products
// of a hi / lo split (K10's OpTf32, tardis_hopper.cuh): x_lo y_hi + x_hi
// y_lo + x_hi y_hi on mma.sync m16n8k8 in fp32 accumulators -- within
// ~2^-20 of x y, at a third of the TF32 rate (495 / 3 TFLOP/s).  A bf16
// K or V value widened to fp32 is exact in TF32 (its lo part is 0), so
// the fp32-q / bf16-K/V pair runs two products per step instead of three
// (q_lo k + q_hi k, p_lo v + p_hi v): taken.
//
// Design.  A CTA owns 64 (query, head) rows of ONE KV head, packed as the
// SIMT kernel packs them (f = qi * G + g), so every K/V tile serves all G
// heads; 4 warps of 16 rows.  CTAs are issued longest-first under causal
// (the last row blocks walk the most tiles).
// * Q is read once from global memory straight into each warp's A
//   fragments, split into hi / lo, and kept in registers (Dh / 8 k-steps
//   of 8 registers).
// * K/V tiles of BN positions (64 for Dh <= 80, else 32: the registers of
//   the O accumulators) sit in shared memory as fp32 rows at
//   OpTf32::pitch (4 mod 8 words), double-buffered: tile j + 1 is copied
//   by 16-byte cp.async while tile j computes.  A view whose strides or
//   alignment are not whole 16-byte chunks, and bf16 K/V (widened to
//   fp32 on the way), are staged by plain loads instead.  Positions at or
//   past the CTA's last visible key arrive as zeros, and tiles past it
//   are never loaded.
// * S = Q.K^T: K's B fragments by ldmatrix (an fp32 row of 4 words is an
//   8 x 8 b16 matrix row: one x4 gives two n-tiles of one k-step), split
//   in registers.
// * The online softmax runs on the S fragments in registers, quad
//   reductions for a row's max and sum, in base 2 with scale * log2(e)
//   folded in once; the causal / kv_len mask only on tiles that cross
//   kv_len or the diagonal of the warp's first row.
// * O += P.V: P goes from the C fragments into A fragments
//   (OpTf32::a_from_c, K10's k permutation) -- P never touches shared
//   memory -- with V's rows as B fragments in the same k order.
// * The three products of one accumulator are a dependent chain, so both
//   products issue them in turns over groups of kGroup accumulators
//   (mma_group): lo.hi of each, then hi.lo, then hi.hi.
// * Head dims are compiled at 32, 64, 80, 96, 112 and 128 columns; a Dh
//   below its build's skips the k-steps and n-tiles past it.
// No atomics: a run replays bit for bit, with and without the LSE write.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tardis_hopper.cuh"

namespace {

constexpr int kWarps = 4;                  // 16 (query, head) rows each
constexpr int kCtaRows = 16 * kWarps;
constexpr int kThreads = 32 * kWarps;

struct Args {
  const float* q;
  const void *k, *v;
  float* out;
  float* lse;                              // null, or (B, H, Sq) fp32
  int b, sq, hkv, g, dh;
  long long qsb, qst, qsh, ksb, kst, ksh;  // strides in elements
  int q_offset, kv_len, causal;
  float scale, scale2;                     // scale2 = scale * log2(e)
  int kv_vec;                              // fp32 K/V in whole 16-byte chunks
};

template <int DH> __host__ __device__ constexpr int tile_keys() {
  return DH <= 80 ? 64 : 32;
}
// CTAs an SM must hold (__launch_bounds__): three for Dh <= 64 (the
// register cap, 170, costs fewer issue slots than the third CTA's warps
// hide: scripts/k6_variants.py); wider heads keep their registers (Q's
// fragments alone take Dh of them)
template <int DH> __host__ __device__ constexpr int min_ctas() {
  return DH <= 64 ? 3 : 1;
}

// n-tiles whose products are issued interleaved: mma.sync's latency is
// many issue slots long, and the three products of one accumulator are
// a dependent chain, so the products of kGroup accumulators go in turns
constexpr int kGroup = 4;

// d[n0 + i] += a . b[i] for the i < ng tiles of a group (b[i] the raw
// fp32 B fragment: rows k = tig and tig + 4): three TF32 products of the
// split (a_lo b_hi, a_hi b_lo, a_hi b_hi: OpTf32::mma's order, so each
// accumulator sums exactly what OpTf32::mma would), or two where b is
// exact in TF32 (bf16 widened to fp32: b_lo = 0); the products of the
// group's accumulators interleaved.  live[i] false (or n0 + i past the
// accumulators): tile i skipped.
template <bool EXACT, int NG, int N>
__device__ __forceinline__ void mma_group(float (&d)[N][4], int n0,
                                          const OpTf32::A& a,
                                          const unsigned (&b)[NG][2],
                                          const bool (&live)[NG]) {
  unsigned hi[NG][2], lo[NG][2];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (EXACT)
        hi[i][r] = b[i][r];
      else
        split_tf32(__uint_as_float(b[i][r]), hi[i][r], lo[i][r]);
    }
#pragma unroll
  for (int i = 0; i < NG; ++i)
    if (n0 + i < N && live[i]) mma_tf32(d[n0 + i], a.lo, hi[i][0], hi[i][1]);
  if constexpr (!EXACT) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (n0 + i < N && live[i]) mma_tf32(d[n0 + i], a.hi, lo[i][0], lo[i][1]);
  }
#pragma unroll
  for (int i = 0; i < NG; ++i)
    if (n0 + i < N && live[i]) mma_tf32(d[n0 + i], a.hi, hi[i][0], hi[i][1]);
}

// The B fragments (k-step k0) of the n-tiles n0 and n0 + 8 of a K tile
// ([position][d] rows at pitch LD): lanes 8 m .. 8 m + 7 address matrix
// m's rows (positions n0 + 8 (m / 2) + r, columns k0 + 4 (m % 2)); lane t
// receives word t % 4 of row t / 4 of each: r[0], r[1] = b0, b1 of n0,
// r[2], r[3] those of n0 + 8
template <int LD>
__device__ __forceinline__ void ldsm_bt2(const float* t, int n0, int k0,
                                         unsigned (&r)[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(r, t + (n0 + ((lane >> 4) << 3) + (lane & 7)) * LD + k0 +
                     ((lane >> 3) & 1) * 4);
}

// The online softmax of one tile for the lane's two rows (u = 0: row grp,
// 1: grp + 8) in base 2 on the raw scores in s (scale * log2(e) folded
// into one FMA): m, l updated, o rescaled, P left in s.  EDGE: the tile
// crosses kv_len or the causal diagonal, so keys are masked; otherwise
// every row sees every key and the row max is finite.
template <bool EDGE, int NS, int ND>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4],
                                               float (&o)[ND][4],
                                               float (&m)[2], float (&l)[2],
                                               const int (&qpos)[2], int t0,
                                               const Args& a) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float mx = kTardisNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (EDGE) {
          const int pos = t0 + n * 8 + 2 * tig + e;
          if (pos >= a.kv_len || (a.causal && pos > qpos[u]))
            s[n][2 * u + e] = kTardisNegInf;
        }
        mx = fmaxf(mx, s[n][2 * u + e]);
      }
    mx = quad_max(mx);
    const float m_new = fmaxf(m[u], mx);
    const float off = -m_new * a.scale2;
    const bool dead = EDGE && m_new <= kTardisNegInf;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = dead ? 0.f : ex2(fmaf(s[n][2 * u + e], a.scale2, off));
        s[n][2 * u + e] = p;
        sum += p;
      }
    const float alpha = ex2((m[u] - m_new) * a.scale2);
    l[u] = l[u] * alpha + quad_sum(sum);
    m[u] = m_new;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * u] *= alpha;
      o[n][2 * u + 1] *= alpha;
    }
  }
}

// Grid: one CTA per (64-row block, b, kv head), the (b, kv head) pairs
// fastest, the row blocks longest-first.
template <typename TKV, int DH>
__global__ void __launch_bounds__(kThreads, min_ctas<DH>())
    flash_prefill_tf32(const Args a) {
  constexpr bool EXACT = !std::is_same<TKV, float>::value;
  constexpr int BN = tile_keys<DH>(), LD = OpTf32::pitch(DH);
  constexpr int KS = DH / 8, NS = BN / 8, ND = DH / 8;
  extern __shared__ __align__(16) float smem[];     // [2][K, V][BN][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int dh = a.dh, H = a.hkv * a.g;
  const int pairs = a.b * a.hkv, pair = blockIdx.x % pairs;
  const int bb = pair / a.hkv, hk = pair - bb * a.hkv;
  const long long n_rows = static_cast<long long>(a.sq) * a.g;
  const long long f0 = static_cast<long long>(
      gridDim.x / pairs - 1 - blockIdx.x / pairs) * kCtaRows;
  const long long f_last = min(f0 + kCtaRows, n_rows) - 1;
  int kv_end = a.kv_len;
  if (a.causal)
    kv_end = min(kv_end, a.q_offset + static_cast<int>(f_last / a.g) + 1);
  kv_end = max(kv_end, 0);
  const int n_tiles = (kv_end + BN - 1) / BN;

  const TKV* kb = static_cast<const TKV*>(a.k) + bb * a.ksb + hk * a.ksh;
  const TKV* vb = static_cast<const TKV*>(a.v) + bb * a.ksb + hk * a.ksh;
  // tile j's K and V into buffer j % 2 (rows past kv_end zero): 16-byte
  // cp.async for an fp32 view in whole chunks (the wait is the loop's),
  // plain loads otherwise (bf16 widened to fp32)
#define TARDIS_STAGE(j)                                                    \
  do {                                                                     \
    float* ks_ = smem + ((j) & 1) * 2 * BN * LD;                           \
    const int n_ = min(BN, kv_end - (j) * BN);                             \
    stage<TKV, float, BN, kThreads>(ks_, LD, kb + (j) * BN * a.kst, a.kst, \
                                    n_, dh, a.kv_vec);                     \
    stage<TKV, float, BN, kThreads>(ks_ + BN * LD, LD,                     \
                                    vb + (j) * BN * a.kst, a.kst, n_, dh,  \
                                    a.kv_vec);                             \
  } while (0)
  if (n_tiles > 0) TARDIS_STAGE(0);          // in flight while Q loads
  cp_async_commit();

  // the warp's rows fw + grp and fw + grp + 8: Q's A fragments, split once
  const long long fw = f0 + warp * 16;
  int qpos[2];
  OpTf32::A qa[KS];
  {
    const float* qrow[2];
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long f = fw + grp + 8 * u;
      ok[u] = f < n_rows;
      const long long qi = (ok[u] ? f : fw) / a.g;
      const int gi = static_cast<int>((ok[u] ? f : fw) - qi * a.g);
      qpos[u] = a.q_offset + static_cast<int>(qi);
      qrow[u] = a.q + bb * a.qsb + qi * a.qst + (hk * a.g + gi) * a.qsh;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 8 + tig;
      const bool in = ks * 8 < dh;
      split_tf32(ok[0] && in ? qrow[0][c] : 0.f, qa[ks].hi[0], qa[ks].lo[0]);
      split_tf32(ok[1] && in ? qrow[1][c] : 0.f, qa[ks].hi[1], qa[ks].lo[1]);
      split_tf32(ok[0] && in ? qrow[0][c + 4] : 0.f, qa[ks].hi[2],
                 qa[ks].lo[2]);
      split_tf32(ok[1] && in ? qrow[1][c + 4] : 0.f, qa[ks].hi[3],
                 qa[ks].lo[3]);
    }
  }
  // the warp's own KV limit, and its first row's position (tiles that end
  // at or below it need no causal mask)
  int kv_end_w = 0, q_first = 0;
  if (fw < n_rows) {
    kv_end_w = a.kv_len;
    if (a.causal)
      kv_end_w = min(kv_end_w, a.q_offset + static_cast<int>(
                                   (min(fw + 16, n_rows) - 1) / a.g) + 1);
    q_first = a.q_offset + static_cast<int>(fw / a.g);
  }
  const int n_tiles_w = (max(kv_end_w, 0) + BN - 1) / BN;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kTardisNegInf, kTardisNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) TARDIS_STAGE(j + 1);  // its buffer's readers are done
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                         // tile j is in for every thread
    if (j < n_tiles_w) {
      const float* Ks = smem + (j & 1) * 2 * BN * LD;
      const float* Vs = Ks + BN * LD;
      // S = Q.K^T: 16 rows x BN keys
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      constexpr int GS = NS < kGroup ? NS : kGroup;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks * 8 < dh) {
#pragma unroll
          for (int n0 = 0; n0 < NS; n0 += GS) {
            unsigned bf[GS][2];
            bool all[GS];
#pragma unroll
            for (int i = 0; i < GS; i += 2) {
              unsigned r[4];
              ldsm_bt2<LD>(Ks, (n0 + i) * 8, ks * 8, r);
              bf[i][0] = r[0];
              bf[i][1] = r[1];
              bf[i + 1][0] = r[2];
              bf[i + 1][1] = r[3];
              all[i] = all[i + 1] = true;
            }
            mma_group<EXACT>(s, n0, qa[ks], bf, all);
          }
        }
      }
      // the online softmax; an edge tile masked, an inner one (every row
      // sees every key) with no mask arithmetic and a finite row max
      const int t0 = j * BN;
      if (t0 + BN > a.kv_len || (a.causal && t0 + BN - 1 > q_first))
        online_softmax<true>(s, o, m, l, qpos, t0, a);
      else
        online_softmax<false>(s, o, m, l, qpos, t0, a);
      // O += P.V: P's A fragments from the C fragments, V's rows 2 tig and
      // 2 tig + 1 of each k-step as k = tig and tig + 4 (a_from_c's order)
      constexpr int GD = ND < kGroup ? ND : kGroup;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const OpTf32::A pa = OpTf32::a_from_c(s, kk);
        const float* vr = Vs + (kk * 8 + 2 * tig) * LD + grp;
#pragma unroll
        for (int n0 = 0; n0 < ND; n0 += GD) {
          unsigned bf[GD][2];
          bool live[GD];
#pragma unroll
          for (int i = 0; i < GD; ++i) {
            const int n = n0 + i;
            live[i] = n < ND && n * 8 < dh;
            bf[i][0] = live[i] ? __float_as_uint(vr[n * 8]) : 0u;
            bf[i][1] = live[i] ? __float_as_uint(vr[LD + n * 8]) : 0u;
          }
          mma_group<EXACT>(o, n0, pa, bf, live);
        }
      }
    }
    __syncthreads();                         // the tile's readers are done
  }
#undef TARDIS_STAGE
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long f = fw + grp + 8 * u;
    if (f >= n_rows) continue;
    const long long qi = f / a.g;
    const int gi = static_cast<int>(f - qi * a.g);
    float* orow = a.out + ((static_cast<long long>(bb) * a.sq + qi) * H +
                           hk * a.g + gi) * dh;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
    if (a.lse && tig == 0)   // m is in raw score units here
      a.lse[(static_cast<long long>(bb) * H + hk * a.g + gi) * a.sq + qi] =
          l[u] > 0.f ? m[u] * a.scale + logf(l[u]) : INFINITY;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * tig) =
            make_float2(o[n][2 * u] * inv, o[n][2 * u + 1] * inv);
  }
}

template <typename TKV, int DH>
int launch(const Args& a, cudaStream_t s) {
  constexpr int smem = 2 * 2 * tile_keys<DH>() * OpTf32::pitch(DH) *
                       static_cast<int>(sizeof(float));
  auto kern = flash_prefill_tf32<TKV, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_rows = static_cast<long long>(a.sq) * a.g;
  const long long n_ctas =
      (n_rows + kCtaRows - 1) / kCtaRows * a.b * a.hkv;
  kern<<<(unsigned)n_ctas, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_dh(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<TKV, 32>(a, s);
  if (a.dh <= 64) return launch<TKV, 64>(a, s);
  if (a.dh <= 80) return launch<TKV, 80>(a, s);
  if (a.dh <= 96) return launch<TKV, 96>(a, s);
  if (a.dh <= 112) return launch<TKV, 112>(a, s);
  return launch<TKV, 128>(a, s);
}

}  // namespace

// The tf32x3 variant of tardis_flash_prefill (flash_prefill.cu), which
// calls it with the same arguments for an fp32 q over fp32 (kv_dtype 0)
// or bf16 (1) K/V and 0 < dh <= 128, dh % 8 == 0.
int tardis_flash_prefill_tf32(const void* q, const void* k, const void* v,
                              void* out, float* lse, int b, int sq, int hkv,
                              int g, int dh, long long qsb, long long qst,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, int q_offset, int kv_len,
                              int causal, float scale, int kv_dtype,
                              cudaStream_t s) {
  if (dh <= 0 || dh > 128 || dh % 8 || kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int kv_vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                     ksb % 4 == 0 && kst % 4 == 0 && ksh % 4 == 0;
  const Args a{static_cast<const float*>(q), k, v, static_cast<float*>(out),
               lse, b, sq, hkv, g, dh, qsb, qst, qsh, ksb, kst, ksh,
               q_offset, kv_len, causal, scale, scale * kTardisLog2e, kv_vec};
  return kv_dtype == 0 ? launch_dh<float>(a, s)
                       : launch_dh<__nv_bfloat16>(a, s);
}
