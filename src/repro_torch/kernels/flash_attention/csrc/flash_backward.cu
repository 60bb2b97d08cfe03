// K10 flash_backward: the gradient of K6 (causal GQA flash attention) with
// respect to q, k and v.
//
// Forward (K6, src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd): query i sits at kv position q_offset + i and sees
// positions t < kv_len (and, causal, t <= q_offset + i); s = q.k_t * scale,
// P = softmax(s) over the live t, o = P.v; query head h reads KV head
// h / G.  Backward, with lse the row's log-sum-exp of s (K6 writes it) and
// D_i = sum_d dO_id * O_id:
//   P_it = exp(s_it - lse_i),  dP_it = dO_i . v_t,  dS_it = P_it (dP_it - D_i)
//   dq_i = scale * sum_t dS_it k_t
//   dk_t = scale * sum_{h in t's group, i} dS_it q_i,  dv_t = sum P_it dO_i
// The JAX package differentiates its blocked jnp schedule with autodiff
// (src/repro/models/attention.py: flash_attention, "the Pallas flash
// kernel implements the same schedule"); this is that gradient, in the
// schedule of FlashAttention-2's backward.  A row with no live key has
// lse = +inf: P = 0 and its gradients are 0, as K6's output there is 0.
//
// Bound on the H100: operations.  Five products of Dh-long dots per live
// (query, key, head) -- s, dP, dv, dq and dk: 10 Dh flop -- over O(S Dh)
// bytes.  This design spends 14 Dh: s and dP are computed once in the dq
// kernel and once in the dk/dv kernel, nothing else twice (the LSE comes
// from K6's forward, so no pass rebuilds it).
//
// Up to four kernels a call (counted as one launch), no float atomics:
// every output element is summed by one thread in an order fixed by the
// shapes, so two calls are bit-identical.
// * flash_bwd_delta: D = rowsum(dO * O) in fp32 (B, H, Sq), a warp a row.
// * flash_bwd_dq: one CTA per (q block of 64 rows, head, batch), 4 warps
//   of 16 rows; one pass over the visible KV tiles: s = Q.K^T, P =
//   exp(s scale - lse), dP = dO.V^T, dS = P (dP - D), dq += dS.K -- each
//   warp keeps its rows' S, dP and dq in registers (no exchange between
//   warps).  CTAs are issued longest-first (the last q blocks see the most
//   tiles under the causal mask).
// * flash_bwd_dkv: one CTA per (KV block of 64 keys, QUERY head, batch), 4
//   warps of 16 keys; one pass over the query tiles that see the block:
//   S^T = K.Q^T, dP^T = V.dO^T, P^T and dS^T from the lse and D, dv +=
//   P^T.dO, dk += dS^T.Q.  A CTA per query head, not per KV head: a CTA
//   looping over the G heads of its group would carry G x 16 tiles at
//   the training shape (B 4, S 1024, 32 / 4 heads) beside 256 CTAs in
//   all; per query head the heaviest carries 16, the mean is 8.5 (no CTA
//   above 1.9x the mean, over 2048 CTAs), and the heaviest (the first KV
//   blocks) are issued first.  With G > 1 each CTA writes its head's
//   fp32 partial dk, dv (scaled) into a (2, B, Skv, H, Dh) workspace;
// * flash_bwd_dkv_sum then sums each KV head's G partials in head order
//   and writes dk, dv in the KV dtype.  With G = 1 the dk/dv kernel writes
//   them itself.
//
// Products on the tensor cores (mma.sync):
// * fp32 q ("tf32x3", over fp32 or bf16 K/V): every operand x is split
//   into x_hi, x rounded to TF32, and x_lo = x - x_hi (split_tf32), and
//   each product as x_lo y_hi + x_hi y_lo + x_hi y_hi on m16n8k8 TF32 in
//   fp32 accumulators: with the dropped x_lo y_lo (~2^-22) and x_lo's
//   truncation by the mma, each product is within ~2^-20 of x y, so the
//   results hold fp32's 2e-4 against the plain version while running at
//   a third of the TF32 rate (495 / 3 TFLOP/s dense) instead of fp32 SIMT
//   (67).  Tiles sit in shared memory as fp32.
// * the bf16 pair ("bf16"): m16n8k16 bf16 with fp32 accumulation on bf16
//   tiles; P and dS are rounded to bf16 as the A operand of P^T.dO,
//   dS^T.Q and dS.K, as FlashAttention-2 does (each within 2^-9 of
//   itself).
// P and dS go from the accumulators of S and dP straight into A operands
// (FlashAttention-2's register reuse): for bf16 the C fragments of two
// adjacent n8 tiles are the A fragment of one k16 step; for TF32 a C
// fragment's columns (2c, 2c+1) are used as k = (c, c + 4), a permutation
// of the k order that the B operand's rows follow (load_b).
// Shared-memory rows are padded to a pitch of 4 mod 8 words, so every
// fragment load is free of bank conflicts.  The next KV tile (dq) or query
// tile (dk/dv) is loaded by 16-byte cp.async into the second buffer while
// the current one computes (synchronously where a view's strides are not
// whole 16-byte chunks or a bf16 K/V is widened to fp32).
// Tiles: 64 keys / queries a tile for Dh <= 64; 32 above (the registers of
// the dq, dk and dv accumulators); for Dh > 128 the accumulators cover 128
// columns at a time (S and dP recomputed per chunk) and the tiles are
// single-buffered (shared memory).  Dh 64 and 128 are compiled with the
// head dim fixed, so that every fragment's shared-memory offset is a
// constant (with the pitch read at run time the address arithmetic took
// more instructions than the products).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tardis_hopper.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;                     // (B, H, Sq) fp32, from K6
  void *dq, *dk, *dv;
  float* delta;                         // (B, H, Sq) fp32
  float* ws;                            // (2, B, Skv, H, Dh) fp32, G > 1
  int b, sq, skv, hkv, g, dh;
  long long qsb, qst, qsh;              // q's strides (elements)
  long long ksb, kst, ksh;              // k's and v's strides
  int q_offset, kv_len, causal;
  float scale, scale2;                  // scale2 = scale * log2(e)
  int q_vec, kv_vec, o_vec;             // whole 16-byte chunks (cp.async)
};

__device__ __forceinline__ bool live(const Args& a, int kpos, int qpos) {
  return kpos < a.kv_len && (!a.causal || kpos <= qpos);
}

// 4 bytes global -> shared, asynchronously; zeros where !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// ---- the two kinds of tensor-core products --------------------------------
// (OpTf32, split_tf32 and mma_tf32 live in tardis_hopper.cuh: K6's tf32x3
// variant shares them)

__device__ __forceinline__ unsigned pack_rows(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

struct OpBf16 {
  using TS = __nv_bfloat16;
  static constexpr int KS = 16;
  struct A { unsigned r[4]; };
  struct B { unsigned r[2]; };
  // 4 mod 8 words, and at least Dh rounded up to 16 columns (the k16
  // steps read the zero padding past Dh)
  __host__ __device__ static constexpr int pitch(int dh) {
    return ((dh / 2 + 7) / 8 * 8 + 4) * 2;
  }
  __device__ static unsigned word(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  __device__ static A load_a(const __nv_bfloat16* t, int ld, int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const __nv_bfloat16* p = t + grp * ld + k0 + 2 * tig;
    return A{{word(p), word(p + 8 * ld), word(p + 8), word(p + 8 * ld + 8)}};
  }
  __device__ static B load_bt(const __nv_bfloat16* t, int ld, int n0,
                              int k0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const __nv_bfloat16* p = t + (n0 + grp) * ld + k0 + 2 * tig;
    return B{{word(p), word(p + 8)}};
  }
  __device__ static B load_b(const __nv_bfloat16* t, int ld, int k0,
                             int n0) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    const __nv_bfloat16* p = t + (k0 + 2 * tig) * ld + n0 + grp;
    return B{{pack_rows(p[0], p[ld]), pack_rows(p[8 * ld], p[9 * ld])}};
  }
  template <int N>
  __device__ static A a_from_c(const float (&c)[N][4], int kk) {
    return A{{pack_bf16(c[2 * kk][0], c[2 * kk][1]),
              pack_bf16(c[2 * kk][2], c[2 * kk][3]),
              pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
              pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])}};
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16_16(d, a.r, b.r[0], b.r[1]);
  }
};

template <typename TQ> struct OpOf { using type = OpTf32; };
template <> struct OpOf<__nv_bfloat16> { using type = OpBf16; };

// zeros in the columns [dh, pitch) of `rows` shared rows (read by the
// bf16 k16 steps past a Dh that is not a multiple of 16)
template <typename TS, int NT>
__device__ __forceinline__ void zero_pad(TS* t, int rows, int ld, int dh) {
  const int w = ld - dh;
  for (int x = threadIdx.x; x < rows * w; x += NT) {
    const int r = x / w;
    t[r * ld + dh + (x - r * w)] = from_f32<TS>(0.f);
  }
}

template <int ST> __device__ __forceinline__ void wait_tile() {
  cp_async_wait<ST - 1>();
  __syncthreads();
}

// ---- D = rowsum(dO * O) --------------------------------------------------

template <typename TQ>
__global__ void __launch_bounds__(256) flash_bwd_delta(const Args a) {
  const int H = a.hkv * a.g, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * 8 +
                      (threadIdx.x >> 5);             // (b, i, h) row
  if (r >= static_cast<long long>(a.b) * a.sq * H) return;
  const TQ* o = static_cast<const TQ*>(a.o) + r * a.dh;
  const TQ* d = static_cast<const TQ*>(a.dout) + r * a.dh;
  float s = 0.f;
  for (int c = lane; c < a.dh; c += 32) s = fmaf(ldf(d + c), ldf(o + c), s);
#pragma unroll
  for (int x = 16; x; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (lane == 0) {
    const long long bi = r / H;
    const int h = static_cast<int>(r - bi * H);
    const long long bb = bi / a.sq, i = bi - bb * a.sq;
    a.delta[(bb * H + h) * a.sq + i] = s;
  }
}

// ---- dq -------------------------------------------------------------------

// BM query rows (BM / 16 warps), BN keys a KV tile, DC dq columns at a
// time, ST buffers of K/V tiles; DH the head dim where it is fixed at
// compile time (every tile offset a constant), 0 where it is a.dh
template <typename TQ, typename TKV, int BM, int BN, int DC, int ST, int DH>
__global__ void __launch_bounds__(BM * 2) flash_bwd_dq(const Args a) {
  using Op = typename OpOf<TQ>::type;
  using TS = typename Op::TS;
  constexpr int NT = BM * 2, NS = BN / 8, ND = DC / 8, KS = Op::KS;
  const int dh = DH ? DH : a.dh, ld = Op::pitch(dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int H = a.hkv * a.g, nqb = (a.sq + BM - 1) / BM;
  const int pairs = H * a.b;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / pairs);
  const int hb = static_cast<int>(blockIdx.x % pairs);
  const int h = hb % H, bb = hb / H, hk = h / a.g;
  const int q0 = qb * BM, nq = min(BM, a.sq - q0);

  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);     // BM, times log2(e)
  float* del_s = lse_s + BM;                         // BM
  TS* Qs = reinterpret_cast<TS*>(del_s + BM);        // BM x ld
  TS* dOs = Qs + BM * ld;                            // BM x ld
  TS* KVs = dOs + BM * ld;                           // ST x (K, V) BN x ld
  if (dh % KS) zero_pad<TS, NT>(Qs, 2 * BM + 2 * ST * BN, ld, dh);
  __syncthreads();

  const long long orow = static_cast<long long>(H) * dh;
  const long long obase = (static_cast<long long>(bb) * a.sq + q0) * orow +
                          static_cast<long long>(h) * dh;
  stage<TQ, TS, BM, NT>(Qs, ld, static_cast<const TQ*>(a.q) + bb * a.qsb +
                        q0 * a.qst + h * a.qsh, a.qst, nq, dh, a.q_vec);
  stage<TQ, TS, BM, NT>(dOs, ld, static_cast<const TQ*>(a.dout) + obase,
                        orow, nq, dh, a.o_vec);
  cp_async_commit();
  const long long lrow = (static_cast<long long>(bb) * H + h) * a.sq + q0;
  for (int i = threadIdx.x; i < BM; i += NT) {
    lse_s[i] = i < nq ? a.lse[lrow + i] * kTardisLog2e : INFINITY;
    del_s[i] = i < nq ? a.delta[lrow + i] : 0.f;
  }

  const int last_q = a.q_offset + q0 + nq - 1;
  int kv_end = a.causal ? min(a.kv_len, last_q + 1) : a.kv_len;
  kv_end = max(0, min(kv_end, a.skv));
  const int nkb = (kv_end + BN - 1) / BN;
  const TKV* kbase = static_cast<const TKV*>(a.k) + bb * a.ksb + hk * a.ksh;
  const TKV* vbase = static_cast<const TKV*>(a.v) + bb * a.ksb + hk * a.ksh;
  auto stage_kv = [&](int j, int buf) {
    const int k0 = j * BN, nk = min(BN, a.skv - k0);
    TS* Ks = KVs + buf * 2 * BN * ld;
    stage<TKV, TS, BN, NT>(Ks, ld, kbase + k0 * a.kst, a.kst, nk, dh,
                           a.kv_vec);
    stage<TKV, TS, BN, NT>(Ks + BN * ld, ld, vbase + k0 * a.kst, a.kst, nk,
                           dh, a.kv_vec);
  };

  const TS* Qw = Qs + warp * 16 * ld;
  const TS* dOw = dOs + warp * 16 * ld;
  TQ* dq = static_cast<TQ*>(a.dq) + obase;
  for (int c0 = 0; c0 < dh; c0 += DC) {
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if constexpr (ST == 2) {
      if (nkb > 0) stage_kv(0, 0);
      cp_async_commit();
    }
    for (int j = 0; j < nkb; ++j) {
      if constexpr (ST == 2) {
        if (j + 1 < nkb) stage_kv(j + 1, (j + 1) & 1);
      } else {
        stage_kv(j, 0);
      }
      cp_async_commit();
      wait_tile<ST>();
      const TS* Ks = KVs + (ST == 2 ? (j & 1) : 0) * 2 * BN * ld;
      const TS* Vs = Ks + BN * ld;
      // S = Q.K^T and dP = dO.V^T: the warp's 16 rows x BN keys
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < dh; k0 += KS) {
        const auto aq = Op::load_a(Qw, ld, k0);
        const auto ad = Op::load_a(dOw, ld, k0);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          Op::mma(s[n], aq, Op::load_bt(Ks, ld, n * 8, k0));
          Op::mma(dp[n], ad, Op::load_bt(Vs, ld, n * 8, k0));
        }
      }
      // P = exp(s scale - lse) where live, dS = P (dP - D), in place
      const int kt0 = j * BN;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = warp * 16 + grp + 8 * u;
        const int qpos = a.q_offset + q0 + r;
        const float nl = -lse_s[r], del = del_s[r];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * u + e];
            const float p = live(a, kt0 + n * 8 + 2 * tig + e, qpos)
                                ? ex2(fmaf(x, a.scale2, nl))
                                : 0.f;
            x = p;
            dp[n][2 * u + e] = p * (dp[n][2 * u + e] - del);
          }
      }
      // dq += dS.K over this chunk's columns
#pragma unroll
      for (int kk = 0; kk < BN / KS; ++kk) {
        const auto ads = Op::a_from_c(dp, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          if (c0 + n * 8 < dh)
            Op::mma(acc[n], ads, Op::load_b(Ks, ld, kk * KS, c0 + n * 8));
      }
      __syncthreads();          // the tile's readers are done
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = warp * 16 + grp + 8 * u;
      if (r >= nq) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = c0 + n * 8 + 2 * tig;
        if (c < dh) {
          dq[r * orow + c] = from_f32<TQ>(acc[n][2 * u] * a.scale);
          dq[r * orow + c + 1] = from_f32<TQ>(acc[n][2 * u + 1] * a.scale);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- dk, dv ---------------------------------------------------------------

// BN keys (BN / 16 warps), BM queries a tile, DC dk / dv columns at a
// time, ST buffers of Q/dO tiles, DH as in flash_bwd_dq
template <typename TQ, typename TKV, int BN, int BM, int DC, int ST, int DH>
__global__ void __launch_bounds__(BN * 2) flash_bwd_dkv(const Args a) {
  using Op = typename OpOf<TQ>::type;
  using TS = typename Op::TS;
  constexpr int NT = BN * 2, NS = BM / 8, ND = DC / 8, KS = Op::KS;
  const int dh = DH ? DH : a.dh, ld = Op::pitch(dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int H = a.hkv * a.g, pairs = H * a.b;
  const int kb = static_cast<int>(blockIdx.x / pairs);   // heaviest first
  const int hb = static_cast<int>(blockIdx.x % pairs);
  const int h = hb % H, bb = hb / H, hk = h / a.g;
  const int k0 = kb * BN, nk = min(BN, a.skv - k0);

  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);     // ST x BM
  float* del_s = lse_s + ST * BM;                    // ST x BM
  TS* Ks = reinterpret_cast<TS*>(del_s + ST * BM);   // BN x ld
  TS* Vs = Ks + BN * ld;                             // BN x ld
  TS* QOs = Vs + BN * ld;                            // ST x (Q, dO) BM x ld
  if (dh % KS) zero_pad<TS, NT>(Ks, 2 * BN + 2 * ST * BM, ld, dh);
  __syncthreads();

  const TKV* kbase = static_cast<const TKV*>(a.k) + bb * a.ksb +
                     k0 * a.kst + hk * a.ksh;
  const TKV* vbase = static_cast<const TKV*>(a.v) + bb * a.ksb +
                     k0 * a.kst + hk * a.ksh;
  stage<TKV, TS, BN, NT>(Ks, ld, kbase, a.kst, nk, dh, a.kv_vec);
  stage<TKV, TS, BN, NT>(Vs, ld, vbase, a.kst, nk, dh, a.kv_vec);
  cp_async_commit();

  const long long orow = static_cast<long long>(H) * dh;
  const long long lrow = (static_cast<long long>(bb) * H + h) * a.sq;
  const TQ* qbase = static_cast<const TQ*>(a.q) + bb * a.qsb + h * a.qsh;
  const TQ* obase = static_cast<const TQ*>(a.dout) +
                    static_cast<long long>(bb) * a.sq * orow +
                    static_cast<long long>(h) * dh;
  auto stage_q = [&](int t, int buf) {
    const int q0 = t * BM, nq = min(BM, a.sq - q0);
    TS* Qt = QOs + buf * 2 * BM * ld;
    stage<TQ, TS, BM, NT>(Qt, ld, qbase + q0 * a.qst, a.qst, nq, dh,
                          a.q_vec);
    stage<TQ, TS, BM, NT>(Qt + BM * ld, ld, obase + q0 * orow, orow, nq,
                          dh, a.o_vec);
    for (int i = threadIdx.x; i < BM; i += NT) {
      const bool ok = i < nq;
      cp_async4(lse_s + buf * BM + i, a.lse + lrow + (ok ? q0 + i : 0), ok);
      cp_async4(del_s + buf * BM + i, a.delta + lrow + (ok ? q0 + i : 0),
                ok);
    }
  };

  // the query tiles that see the block: causal, from key k0's first
  // query on; none where the block lies at or past kv_len
  const int nqt = (a.sq + BM - 1) / BM;
  const int t_lo = k0 >= a.kv_len ? nqt
                   : a.causal    ? max(0, k0 - a.q_offset) / BM
                                 : 0;
  const TS* Kw = Ks + warp * 16 * ld;
  const TS* Vw = Vs + warp * 16 * ld;
  for (int c0 = 0; c0 < dh; c0 += DC) {
    float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
    if constexpr (ST == 2) {
      if (t_lo < nqt) stage_q(t_lo, 0);
      cp_async_commit();
    }
    for (int t = t_lo; t < nqt; ++t) {
      const int buf = ST == 2 ? (t - t_lo) & 1 : 0;
      if constexpr (ST == 2) {
        if (t + 1 < nqt) stage_q(t + 1, buf ^ 1);
      } else {
        stage_q(t, 0);
      }
      cp_async_commit();
      wait_tile<ST>();
      const TS* Qt = QOs + buf * 2 * BM * ld;
      const TS* dOt = Qt + BM * ld;
      // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 keys x BM queries
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < dh; d0 += KS) {
        const auto ak = Op::load_a(Kw, ld, d0);
        const auto av = Op::load_a(Vw, ld, d0);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          Op::mma(s[n], ak, Op::load_bt(Qt, ld, n * 8, d0));
          Op::mma(dp[n], av, Op::load_bt(dOt, ld, n * 8, d0));
        }
      }
      // P^T and dS^T in place; a column is a query (its lse and D)
      const float* lt = lse_s + buf * BM;
      const float* dt = del_s + buf * BM;
      const int q0 = t * BM;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = n * 8 + 2 * tig + e;
          const int qi = q0 + i;
          const float nl = -lt[i] * kTardisLog2e, del = dt[i];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = k0 + warp * 16 + grp + 8 * u;
            float& x = s[n][2 * u + e];
            const float p = qi < a.sq && live(a, key, a.q_offset + qi)
                                ? ex2(fmaf(x, a.scale2, nl))
                                : 0.f;
            x = p;
            dp[n][2 * u + e] = p * (dp[n][2 * u + e] - del);
          }
        }
      // dv += P^T.dO and dk += dS^T.Q over this chunk's columns
#pragma unroll
      for (int kk = 0; kk < BM / KS; ++kk) {
        const auto ap = Op::a_from_c(s, kk);
        const auto ads = Op::a_from_c(dp, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          if (c0 + n * 8 < dh) {
            Op::mma(acc_v[n], ap, Op::load_b(dOt, ld, kk * KS, c0 + n * 8));
            Op::mma(acc_k[n], ads, Op::load_b(Qt, ld, kk * KS, c0 + n * 8));
          }
      }
      __syncthreads();          // the tile's readers are done
    }
    // G = 1: dk, dv in the KV dtype; else this head's fp32 partials
    const long long n_ws = static_cast<long long>(a.b) * a.skv * H * dh;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = warp * 16 + grp + 8 * u;
      if (j >= nk) continue;
      const long long key = static_cast<long long>(bb) * a.skv + k0 + j;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = c0 + n * 8 + 2 * tig;
        if (c >= dh) continue;
        if (a.g == 1) {
          const long long at = (key * a.hkv + hk) * dh + c;
          TKV* dk = static_cast<TKV*>(a.dk) + at;
          TKV* dv = static_cast<TKV*>(a.dv) + at;
          dk[0] = from_f32<TKV>(acc_k[n][2 * u] * a.scale);
          dk[1] = from_f32<TKV>(acc_k[n][2 * u + 1] * a.scale);
          dv[0] = from_f32<TKV>(acc_v[n][2 * u]);
          dv[1] = from_f32<TKV>(acc_v[n][2 * u + 1]);
        } else {
          float* wk = a.ws + (key * H + h) * dh + c;
          *reinterpret_cast<float2*>(wk) = make_float2(
              acc_k[n][2 * u] * a.scale, acc_k[n][2 * u + 1] * a.scale);
          *reinterpret_cast<float2*>(wk + n_ws) =
              make_float2(acc_v[n][2 * u], acc_v[n][2 * u + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// dk, dv (B, Skv, Hkv, Dh) = the sum over each KV head's G query heads, in
// head order, of the partials (2, B, Skv, H, Dh): four columns a thread
template <typename TKV>
__global__ void __launch_bounds__(256) flash_bwd_dkv_sum(const Args a) {
  const long long n4 =
      static_cast<long long>(a.b) * a.skv * a.hkv * a.dh / 4;
  const long long x = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (x >= n4) return;
  const int dq4 = a.dh / 4;
  const long long row = x / dq4;                   // (b, key, kv head)
  const int c = static_cast<int>(x - row * dq4) * 4;
  const long long n_ws = static_cast<long long>(a.b) * a.skv * a.hkv * a.g *
                         a.dh;
  const float* wk = a.ws + row * a.g * a.dh + c;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int gi = 0; gi < a.g; ++gi) {
    const float4 k4 = *reinterpret_cast<const float4*>(wk + gi * a.dh);
    const float4 v4 = *reinterpret_cast<const float4*>(wk + n_ws +
                                                        gi * a.dh);
    sk.x += k4.x; sk.y += k4.y; sk.z += k4.z; sk.w += k4.w;
    sv.x += v4.x; sv.y += v4.y; sv.z += v4.z; sv.w += v4.w;
  }
  TKV* dk = static_cast<TKV*>(a.dk) + row * a.dh + c;
  TKV* dv = static_cast<TKV*>(a.dv) + row * a.dh + c;
  dk[0] = from_f32<TKV>(sk.x); dk[1] = from_f32<TKV>(sk.y);
  dk[2] = from_f32<TKV>(sk.z); dk[3] = from_f32<TKV>(sk.w);
  dv[0] = from_f32<TKV>(sv.x); dv[1] = from_f32<TKV>(sv.y);
  dv[2] = from_f32<TKV>(sv.z); dv[3] = from_f32<TKV>(sv.w);
}

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// tiles (query rows of a dq CTA = keys of a dk/dv CTA = 64; KV tile of
// the dq kernel = query tile of the dk/dv kernel = BT), DC accumulator
// columns, ST buffers
template <typename TQ, typename TKV, int BT, int DC, int ST, int DH = 0>
int launch_cfg(const Args& a, cudaStream_t s) {
  using TS = typename OpOf<TQ>::type::TS;
  constexpr int BR = 64;
  const int ld = OpOf<TQ>::type::pitch(a.dh);
  const int H = a.hkv * a.g;
  const size_t dq_smem = 2 * BR * sizeof(float) +
                         (size_t)(2 * BR + 2 * ST * BT) * ld * sizeof(TS);
  const size_t dkv_smem = 2 * ST * BT * sizeof(float) +
                          (size_t)(2 * BR + 2 * ST * BT) * ld * sizeof(TS);
  auto dq_k = flash_bwd_dq<TQ, TKV, BR, BT, DC, ST, DH>;
  auto dkv_k = flash_bwd_dkv<TQ, TKV, BR, BT, DC, ST, DH>;
  cudaError_t e = allow_smem(dq_k, dq_smem);
  if (e == cudaSuccess) e = allow_smem(dkv_k, dkv_smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = static_cast<long long>(a.b) * a.sq * H;
  flash_bwd_delta<TQ><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long pairs = static_cast<long long>(H) * a.b;
  dq_k<<<(unsigned)((a.sq + BR - 1) / BR * pairs), 2 * BR, dq_smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dkv_k<<<(unsigned)((a.skv + BR - 1) / BR * pairs), 2 * BR, dkv_smem,
          s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (a.g > 1) {
    const long long n4 =
        static_cast<long long>(a.b) * a.skv * a.hkv * a.dh / 4;
    flash_bwd_dkv_sum<TKV><<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const Args& a, cudaStream_t s) {
  // Dh 64 (tinyllama's, the training path's) and 128 with every tile
  // offset a constant; other Dh with the pitch read at run time
  if (a.dh == 64) return launch_cfg<TQ, TKV, 64, 64, 2, 64>(a, s);
  if (a.dh <= 64) return launch_cfg<TQ, TKV, 64, 64, 2>(a, s);
  if (a.dh == 128) return launch_cfg<TQ, TKV, 32, 128, 2, 128>(a, s);
  if (a.dh <= 128) return launch_cfg<TQ, TKV, 32, 128, 2>(a, s);
  return launch_cfg<TQ, TKV, 32, 128, 1>(a, s);
}

bool whole_chunks(const void* p, long long s0, long long s1, long long s2,
                  int elem) {
  const long long e = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % e == 0 &&
         s1 % e == 0 && s2 % e == 0;
}

}  // namespace

// q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) at the given strides (Dh
// contiguous, k and v at equal strides); o, dout, dq contiguous (B, Sq, H,
// Dh); lse (K6's) and delta (scratch) (B, H, Sq) fp32; dk, dv contiguous
// (B, Skv, Hkv, Dh); ws, where G > 1, (2, B, Skv, H, Dh) fp32 scratch.
// kv_len <= Skv.
extern "C" int tardis_flash_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* ws, int b, int sq, int skv, int hkv, int g, int dh,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, int q_offset, int kv_len, int causal,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0 || skv == 0 || hkv == 0 || g == 0)
    return (int)cudaGetLastError();
  if (dh <= 0 || dh > 256 || dh % 8 || kv_len > skv || (g > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const int eq = q_dtype == 0 ? 4 : 2, ekv = kv_dtype == 0 ? 4 : 2;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(delta), static_cast<float*>(ws),
         b, sq, skv, hkv, g, dh, qsb, qst, qsh, ksb, kst, ksh,
         q_offset, kv_len, causal, scale, scale * kTardisLog2e,
         whole_chunks(q, qsb, qst, qsh, eq),
         whole_chunks(k, ksb, kst, ksh, ekv) &&
             whole_chunks(v, ksb, kst, ksh, ekv),
         whole_chunks(o, 0, 0, 0, eq) && whole_chunks(dout, 0, 0, 0, eq)};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(a, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(a, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
