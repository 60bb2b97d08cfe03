// K4 paged_decode: GQA flash-decode of one query token per request over KV
// that lives in LeaseEngine pool pages.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
// paged_decode_attention_grouped (_paged_decode_kernel).  Semantics kept:
// the current token's fresh (k, v) is folded in first (m = s0, l = 1,
// acc = cv), then request b streams its pages page_rows[b, j] and masks
// positions >= lengths[b]; K and V of kv head h are read at columns
// k_off + h*dh / v_off + h*dh of each pool token row; the online softmax
// runs in fp32 and the output is written in q's dtype.  q and the pool
// share one dtype, float32 or bfloat16 (the serving path runs bf16).
//
// Grid: one CTA per (request b, kv head h); the CTA holds the G query heads
// of that kv head.  The TPU kernel walked all P (clamped) page-table
// entries; this one walks only positions < lengths[b] (ceil(len/chunk)
// pages).  Masked positions added exactly 0 there, so the result is the
// same.  Tokens stream in tiles of kTile positions: the tile's K and V rows
// (dh contiguous elements each, strided by the pool's token row) go to
// shared memory as fp32, then scores, the softmax update and the P.V
// accumulate run out of shared memory.  K rows sit dh + 1 floats apart:
// in the score loop the 32 lanes of a warp read 32 different positions at
// one d, which a stride of dh (a multiple of 32) would put in one bank.
// G, dh, chunk, k_off, v_off and the token row are runtime arguments
// (dh <= 256).
//
// Bound on the H100: bytes.  A decode step reads each live KV element once
// (2 * len * dh * 2 B per kv head) and does 4 * G flops per element, far
// below the ~295 flop/B where the tensor cores would bind.  At the serving
// shapes (B = 8, 4 kv heads, len ~ 100) a launch moves well under 1 MB, so
// launch latency dominates; tensor cores and TMA are not used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

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
      float s = kNegInf;
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
int launch(const void* q, const void* ck, const void* cv, const void* pool,
           const void* page_rows, const void* lengths, int b, int hkv, int g,
           int dh, int chunk, int p_max, long long token_row, int k_off,
           int v_off, float scale, void* out, cudaStream_t stream) {
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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q and the pool share one.
extern "C" int tardis_paged_decode(const void* q, const void* cur_k,
                                   const void* cur_v, const void* pool,
                                   const void* page_rows, const void* lengths,
                                   int b, int hkv, int g, int dh, int chunk,
                                   int p_max, long long token_row, int k_off,
                                   int v_off, float scale, int q_dtype,
                                   int pool_dtype, void* out, void* stream) {
  if (b == 0 || hkv == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype != pool_dtype) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch<float, float>(q, cur_k, cur_v, pool, page_rows, lengths, b,
                                hkv, g, dh, chunk, p_max, token_row, k_off,
                                v_off, scale, out, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, cur_k, cur_v, pool, page_rows, lengths, b, hkv, g, dh, chunk, p_max,
      token_row, k_off, v_off, scale, out, s);
}
