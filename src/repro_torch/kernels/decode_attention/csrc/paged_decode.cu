// K4 paged_decode: GQA flash-decode of one query token per request over KV
// that lives in LeaseEngine pool pages.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
// paged_decode_attention_grouped (_paged_decode_kernel).  Semantics kept:
// the current token's fresh (k, v) is folded in first (m = s0, l = 1,
// acc = cv), then request b reads positions < lengths[b] (clamped to
// p_max * chunk) through page_rows[b, pos / chunk] * chunk + pos % chunk;
// K and V of kv head h are read at columns k_off + h*dh / v_off + h*dh of
// each pool token row; the softmax runs in fp32 and the output is written
// in q's dtype.  q and the pool are float32 or bfloat16, one dtype or an
// fp32 q over a bf16 pool (the serving path runs bf16; fp32 weights put
// their KV in the engine's bf16 pool).  The TPU kernel walked all P (clamped)
// page-table entries; this one reads only the entries of live pages.
// Masked positions added exactly 0 there, so the result is the same.
//
// Bound on the H100: bytes.  A decode step reads each live KV element once
// (2 * len * dh * 2 B per kv head) and does 4 * G flops per element, far
// below the ~295 flop/B where the tensor cores would bind.  At the serving
// shapes (B = 8, 4 kv heads, len ~ 100) a launch moves well under 1 MB:
// what costs is the chain of latencies around each position.  The first
// design (kept below as the SIMT variant) ran one 128-thread CTA per
// (request, kv head) -- 32 CTAs on 132 SMs -- staging 32-position tiles by
// scalar loads with a page lookup per element, four CTA barriers a tile
// and the online softmax in G of the 128 threads.
//
// The tensor-core variant (the bf16 pair, Dh a multiple of 16 up to 128)
// is K5's split-position design (dense_decode.cu) on paged rows:
// * Grid (B * Hkv * ceil(G / 8), n_split) in clusters of (1, n_split):
//   the CTAs of one (request, kv head) pair form one thread-block cluster.
//   The wrapper picks n_split (at most 8) from the lengths' bound p_max *
//   chunk it already has (kernel.paged_split, no host sync); each CTA
//   takes ceil(len / n_split) of request b's live positions, computed on
//   the device from lengths[b], so short and long requests of one batch
//   both spread over their CTAs.
// * Each warp streams runs of 16 positions through its own cp.async ring:
//   lane l copies position l % 16 -- one page-table lookup per position --
//   as 16-byte vectors of its K and V slices (dh * 2 contiguous bytes
//   each), into rows swizzled by 16-byte chunk.  No CTA barrier in the
//   loop.  Token rows or K/V columns that are not 16-byte aligned take the
//   same kernel with plain loads into the ring (VEC = false).
// * Q.K^T and P.V on mma.sync m16n8k16 with the G query heads as rows
//   (padded to 16); P enters P.V exactly, as three bf16 parts whose sum is
//   the fp32 P, so the products are those of the fp32 P.  The current
//   token is folded into warp 0 of the cluster's first CTA as its
//   starting (m, l, acc).
// * One merge at the end: across the warps through shared memory, then
//   across the cluster's CTAs through distributed shared memory behind
//   one cluster barrier (finish_cluster, tardis_hopper.cuh).
// The fp32 pair, an fp32 q over a bf16 pool, and bf16 at any other Dh run
// the SIMT variant.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tardis_hopper.cuh"

namespace {

// ---- the SIMT variant (fp32 q; bf16 at Dh the tensor-core variant lacks) --

constexpr int kTile = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TQ, typename TP>
__global__ void paged_decode_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ cur_k,
    const TP* __restrict__ cur_v, const TP* __restrict__ pool,
    const int* __restrict__ page_rows, const int* __restrict__ lengths,
    int hkv, int g, int dh, int chunk, int p_max, long long token_row,
    int k_off, int v_off, float scale, TQ* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;                   // g * dh
  const int ks_row = dh + 1;          // padded: no bank conflicts
  float* ks = qs + g * dh;            // kTile * ks_row
  float* vs = ks + kTile * ks_row;    // kTile * dh
  float* sc = vs + kTile * dh;        // g * kTile
  float* acc = sc + g * kTile;        // g * dh
  float* m_l = acc + g * dh;          // g maxima, then g sums
  float* alpha = m_l + 2 * g;         // g

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long bh = static_cast<long long>(b) * hkv + h;
  const TQ* qb = q + bh * g * dh;
  for (int x = tid; x < g * dh; x += nt) qs[x] = to_f32(qb[x]);
  for (int x = tid; x < dh; x += nt) {      // the current token
    ks[x] = to_f32(cur_k[bh * dh + x]);
    vs[x] = to_f32(cur_v[bh * dh + x]);
  }
  __syncthreads();
  for (int gi = tid; gi < g; gi += nt) {
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s += qs[gi * dh + d] * ks[d];
    m_l[gi] = s * scale;                    // m = s0
    m_l[g + gi] = 1.f;                      // l = 1
  }
  for (int x = tid; x < g * dh; x += nt) acc[x] = vs[x % dh];  // acc = cv
  __syncthreads();

  const int len = min(lengths[b], p_max * chunk);
  const int* pages = page_rows + static_cast<long long>(b) * p_max;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n_t = min(kTile, len - t0);
    for (int x = tid; x < kTile * dh; x += nt) {
      const int t = x / dh, d = x - t * dh;
      float kv = 0.f, vv = 0.f;
      if (t < n_t) {
        const int pos = t0 + t;
        const long long row =
            static_cast<long long>(pages[pos / chunk]) * chunk + pos % chunk;
        const TP* base = pool + row * token_row + h * dh + d;
        kv = to_f32(base[k_off]);
        vv = to_f32(base[v_off]);
      }
      ks[t * ks_row + d] = kv;
      vs[x] = vv;
    }
    __syncthreads();
    for (int x = tid; x < g * kTile; x += nt) {
      const int gi = x / kTile, t = x - gi * kTile;
      float s = kTardisNegInf;
      if (t < n_t) {
        s = 0.f;
        for (int d = 0; d < dh; ++d)
          s += qs[gi * dh + d] * ks[t * ks_row + d];
        s *= scale;
      }
      sc[x] = s;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += nt) {
      const float m_prev = m_l[gi];
      float m_new = m_prev;
      for (int t = 0; t < n_t; ++t) m_new = fmaxf(m_new, sc[gi * kTile + t]);
      const float a = expf(m_prev - m_new);
      float l = m_l[g + gi] * a;
      for (int t = 0; t < kTile; ++t) {
        const float p = t < n_t ? expf(sc[gi * kTile + t] - m_new) : 0.f;
        sc[gi * kTile + t] = p;
        l += p;
      }
      m_l[gi] = m_new;
      m_l[g + gi] = l;
      alpha[gi] = a;
    }
    __syncthreads();
    for (int x = tid; x < g * dh; x += nt) {
      const int gi = x / dh, d = x - gi * dh;
      float a = acc[x] * alpha[gi];
      for (int t = 0; t < n_t; ++t) a += sc[gi * kTile + t] * vs[t * dh + d];
      acc[x] = a;
    }
    __syncthreads();
  }
  TQ* ob = out + bh * g * dh;
  for (int x = tid; x < g * dh; x += nt)
    ob[x] = from_f32<TQ>(acc[x] / fmaxf(m_l[g + x / dh], 1e-30f));
}

template <typename TQ, typename TP>
int launch_simt(const void* q, const void* ck, const void* cv,
                const void* pool, const void* page_rows, const void* lengths,
                int b, int hkv, int g, int dh, int chunk, int p_max,
                long long token_row, int k_off, int v_off, float scale,
                void* out, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * g * dh + kTile * (2 * dh + 1) + g * kTile + 3 * g);
  auto kern = paged_decode_kernel<TQ, TP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(b, hkv), 128, smem, stream>>>(
      (const TQ*)q, (const TP*)ck, (const TP*)cv, (const TP*)pool,
      (const int*)page_rows, (const int*)lengths, hkv, g, dh, chunk, p_max,
      token_row, k_off, v_off, scale, (TQ*)out);
  return (int)cudaGetLastError();
}

// ---- the tensor-core variant for the bf16 pair -----------------------------

constexpr int kMmaWarps = 4;     // a CTA
constexpr int kHeadChunk = 8;    // query heads per CTA, at most

// 16 bytes (8 bf16 at 2-byte alignment) global -> shared with plain loads;
// zeros where !ok
__device__ __forceinline__ void copy16_plain(void* dst,
                                             const __nv_bfloat16* src,
                                             bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    v.x = pack_pair(src);
    v.y = pack_pair(src + 2);
    v.z = pack_pair(src + 4);
    v.w = pack_pair(src + 6);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <int DH, bool VEC>
__global__ void __launch_bounds__(kMmaWarps * 32) paged_decode_mma(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ cur_k,
    const __nv_bfloat16* __restrict__ cur_v,
    const __nv_bfloat16* __restrict__ pool,
    const int* __restrict__ page_rows, const int* __restrict__ lengths,
    int hkv, int g, int chunk, int p_max, long long token_row, int k_off,
    int v_off, int n_hc, float scale2, __nv_bfloat16* __restrict__ out) {
  using Tile = DecodeRing<DH, kMmaWarps>;
  constexpr int KS = DH / 16, ND = DH / 8, HALF = DH / 16;
  constexpr int NST = Tile::kStages, PITCH = Tile::kPitch;
  extern __shared__ uint4 ring[];         // [kMmaWarps][NST][K, V tiles]
  const int n_split = gridDim.y, sp = blockIdx.y, pid = blockIdx.x;
  const int hc = pid % n_hc, bh = pid / n_hc;
  const int b = bh / hkv, h = bh - b * hkv;
  const int g0 = hc * kHeadChunk, ng = min(g - g0, kHeadChunk);
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const int warp = threadIdx.x >> 5;
  // q as A fragments (row grp is head g0 + grp, rows 8-15 are zero),
  // loaded before lengths[b] so that the two loads overlap
  unsigned qa[KS][2];
  const __nv_bfloat16* qrow =
      q + (static_cast<long long>(bh) * g + g0 + min(grp, ng - 1)) * DH;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = grp < ng ? pack_pair(qrow + ks * 16 + 2 * tig) : 0u;
    qa[ks][1] = grp < ng ? pack_pair(qrow + ks * 16 + 8 + 2 * tig) : 0u;
  }
  const int len = max(0, min(lengths[b], p_max * chunk));
  __nv_bfloat16* ob = out + (static_cast<long long>(bh) * g + g0) * DH;
  // request b's live positions, spread over the cluster's CTAs (a CTA past
  // len takes none but still joins the merge)
  const int per = (len + n_split - 1) / n_split;
  const int lo = min(sp * per, len), hi = min(lo + per, len);
  const int* pages = page_rows + static_cast<long long>(b) * p_max;
  const __nv_bfloat16* kcol = pool + k_off + h * DH;
  const __nv_bfloat16* vcol = pool + v_off + h * DH;
  unsigned char* wring =
      reinterpret_cast<unsigned char*>(ring) + warp * NST * 2 * Tile::kTile;
  constexpr int kRound = kMmaWarps * kDecodeStagePos;  // a round's positions
  const int n_it = (hi - lo + kRound - 1) / kRound;
  // lane: position r of a stage, chunks c0 .. c0 + HALF - 1 of its rows
  const int r = lane & 15, c0 = (lane >> 4) * HALF;

  auto issue = [&](int it) {              // this warp's stage `it`
    if (it < n_it) {
      const int pos = lo + (it * kMmaWarps + warp) * kDecodeStagePos + r;
      const bool ok = pos < hi;
      const long long row =
          ok ? static_cast<long long>(pages[pos / chunk]) * chunk +
                   pos % chunk
             : 0;
      unsigned char* dst = wring + (it % NST) * 2 * Tile::kTile;
      const __nv_bfloat16* kr = kcol + row * token_row;
      const __nv_bfloat16* vr = vcol + row * token_row;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j;
        if constexpr (VEC) {
          cp_async16(dst + swz(r, c, PITCH), ok ? kr + c * 8 : pool, ok);
          cp_async16(dst + Tile::kTile + swz(r, c, PITCH),
                     ok ? vr + c * 8 : pool, ok);
        } else {
          copy16_plain(dst + swz(r, c, PITCH), kr + c * 8, ok);
          copy16_plain(dst + Tile::kTile + swz(r, c, PITCH), vr + c * 8, ok);
        }
      }
    }
    if constexpr (VEC) cp_async_commit();  // an empty group past the end
  };
#pragma unroll
  for (int s = 0; s < NST; ++s) issue(s);

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m = kTardisNegInf, l = 0.f;
  if (sp == 0 && warp == 0) {
    // the current token: m = s0 (base 2, scaled), l = 1, acc = cv
    const __nv_bfloat16* kr = cur_k + static_cast<long long>(bh) * DH;
    float s0 = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const unsigned kk = pack_pair(kr + ks * 16 + hf * 8 + 2 * tig);
        s0 = fmaf(bf16_lo(qa[ks][hf]), bf16_lo(kk), s0);
        s0 = fmaf(bf16_hi(qa[ks][hf]), bf16_hi(kk), s0);
      }
    m = quad_sum(s0) * scale2;
    l = 1.f;
    const __nv_bfloat16* vr = cur_v + static_cast<long long>(bh) * DH;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const unsigned vv = pack_pair(vr + nd * 8 + 2 * tig);
      acc[nd][0] = bf16_lo(vv);
      acc[nd][1] = bf16_hi(vv);
    }
  }

  for (int it = 0; it < n_it; ++it) {
    if constexpr (VEC) cp_async_wait<NST - 1>();
    __syncwarp();                         // every lane's copies landed
    const unsigned char* kt = wring + (it % NST) * 2 * Tile::kTile;
    decode_stage<DH>(kt, kt + Tile::kTile, qa,
                     lo + (it * kMmaWarps + warp) * kDecodeStagePos, hi,
                     scale2, m, l, acc);
    __syncwarp();                         // the slot is read: refill it
    issue(it + NST);
  }
  if constexpr (VEC) cp_async_wait<0>();

  __syncthreads();
  float* wml = reinterpret_cast<float*>(ring);     // [kMmaWarps][2][8]
  float* wacc = wml + kMmaWarps * 2 * kHeadChunk;  // [warps][8][stride]
  if (tig == 0) {
    wml[(warp * 2) * kHeadChunk + grp] = m;
    wml[(warp * 2 + 1) * kHeadChunk + grp] = l;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<float2*>(
        wacc + (warp * kHeadChunk + grp) * acc_stride(DH) + nd * 8 + 2 * tig) =
        make_float2(acc[nd][0], acc[nd][1]);
  }
  __syncthreads();
  finish_cluster<__nv_bfloat16, kHeadChunk, kMmaWarps>(
      wml, wacc,
      reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                               part_offset(Tile::kBytes, kMmaWarps,
                                           kHeadChunk, DH)),
      ng, DH, ob);
}

template <int DH, bool VEC>
int launch_mma(const void* q, const void* ck, const void* cv,
               const void* pool, const void* page_rows, const void* lengths,
               int b, int hkv, int g, int chunk, int p_max,
               long long token_row, int k_off, int v_off, int n_split,
               float scale, void* out, cudaStream_t stream) {
  const int n_hc = (g + kHeadChunk - 1) / kHeadChunk;
  return launch_cluster(
      paged_decode_mma<DH, VEC>, b * hkv * n_hc, n_split, kMmaWarps,
      smem_bytes(DecodeRing<DH, kMmaWarps>::kBytes, kMmaWarps, kHeadChunk,
                 DH, n_split),
      stream, (const __nv_bfloat16*)q, (const __nv_bfloat16*)ck,
      (const __nv_bfloat16*)cv, (const __nv_bfloat16*)pool,
      (const int*)page_rows, (const int*)lengths, hkv, g, chunk, p_max,
      token_row, k_off, v_off, n_hc, scale * kTardisLog2e,
      (__nv_bfloat16*)out);
}

// The bf16 pair at Dh a multiple of 16 up to 128 on the tensor cores;
// -1 for a Dh it has no instance of.
template <bool VEC>
int try_mma(const void* q, const void* ck, const void* cv, const void* pool,
            const void* page_rows, const void* lengths, int b, int hkv,
            int g, int dh, int chunk, int p_max, long long token_row,
            int k_off, int v_off, int n_split, float scale, void* out,
            cudaStream_t s) {
#define TARDIS_K4_MMA(D)                                                   \
  case D:                                                                  \
    return launch_mma<D, VEC>(q, ck, cv, pool, page_rows, lengths, b, hkv, \
                              g, chunk, p_max, token_row, k_off, v_off,    \
                              n_split, scale, out, s);
  switch (dh) {
    TARDIS_K4_MMA(16) TARDIS_K4_MMA(32) TARDIS_K4_MMA(48) TARDIS_K4_MMA(64)
    TARDIS_K4_MMA(80) TARDIS_K4_MMA(96) TARDIS_K4_MMA(112)
    TARDIS_K4_MMA(128)
  }
#undef TARDIS_K4_MMA
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q and the pool share one, or q
// is float32 over a bfloat16 pool (SIMT only; cur_k / cur_v in the pool's).
// variant: 0 the SIMT kernel (any dh <= 256; n_split unused), 1 the
// tensor-core kernel with 16-byte asynchronous copies (bf16, dh a multiple
// of 16 up to 128; the pool, token_row * 2, k_off * 2 and v_off * 2 bytes
// 16-byte aligned), 2 the tensor-core kernel with plain loads (bf16, dh a
// multiple of 16 up to 128, any alignment).  The caller picks it and
// n_split (1 to 8: the cluster of one (request, kv head, 8-head chunk)).
extern "C" int tardis_paged_decode(const void* q, const void* cur_k,
                                   const void* cur_v, const void* pool,
                                   const void* page_rows, const void* lengths,
                                   int b, int hkv, int g, int dh, int chunk,
                                   int p_max, long long token_row, int k_off,
                                   int v_off, float scale, int q_dtype,
                                   int pool_dtype, int n_split, int variant,
                                   void* out, void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if ((q_dtype == 1 && pool_dtype != 1) || chunk <= 0 || p_max <= 0)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (pool_dtype == 0)
      return launch_simt<float, float>(q, cur_k, cur_v, pool, page_rows,
                                       lengths, b, hkv, g, dh, chunk, p_max,
                                       token_row, k_off, v_off, scale, out,
                                       s);
    if (q_dtype == 0)
      return launch_simt<float, __nv_bfloat16>(
          q, cur_k, cur_v, pool, page_rows, lengths, b, hkv, g, dh, chunk,
          p_max, token_row, k_off, v_off, scale, out, s);
    return launch_simt<__nv_bfloat16, __nv_bfloat16>(
        q, cur_k, cur_v, pool, page_rows, lengths, b, hkv, g, dh, chunk,
        p_max, token_row, k_off, v_off, scale, out, s);
  }
  if (q_dtype != 1 || n_split <= 0 || n_split > kTardisMaxSplit)
    return (int)cudaErrorInvalidValue;
  int r = -1;
  if (variant == 1) {
    if (reinterpret_cast<uintptr_t>(pool) % 16 || token_row % 8 ||
        k_off % 8 || v_off % 8)
      return (int)cudaErrorMisalignedAddress;
    r = try_mma<true>(q, cur_k, cur_v, pool, page_rows, lengths, b, hkv, g,
                      dh, chunk, p_max, token_row, k_off, v_off, n_split,
                      scale, out, s);
  } else if (variant == 2) {
    r = try_mma<false>(q, cur_k, cur_v, pool, page_rows, lengths, b, hkv, g,
                       dh, chunk, p_max, token_row, k_off, v_off, n_split,
                       scale, out, s);
  }
  return r >= 0 ? r : (int)cudaErrorInvalidValue;
}
