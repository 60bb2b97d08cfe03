// K10 flash_backward: the gradient of K6 (causal GQA flash attention) with
// respect to q, k and v.
//
// Forward (K6, src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd): query i sits at kv position q_offset + i and sees
// positions t < kv_len (and, causal, t <= q_offset + i); s = q.k_t * scale,
// P = softmax(s) over the live t, o = P.v; query head h reads KV head
// h / G.  Backward, with lse the row's log-sum-exp of s and
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
// Two kernels, no float atomics (every output element is summed by one
// thread in an order fixed by the shapes, so two calls are bit identical):
// * flash_bwd_dq, one CTA per (q block of BM rows, head, batch): it stages
//   its Q and dO rows in shared memory, computes D (a warp a row) and, in a
//   first pass over the visible KV tiles, the rows' lse (an online max and
//   sum); it writes both, fp32 (B, H, Sq), for the second kernel; then a
//   second pass over the same tiles recomputes P, dP and dS and accumulates
//   dq in registers.
// * flash_bwd_dkv, one CTA per (kv block of BM rows, kv head, batch): it
//   stages its K and V rows, then loops over the G query heads of the group
//   and the q blocks that see the block (causal: from the block's first
//   position on), recomputes P = exp(s - lse) and dS from the lse and D the
//   first kernel wrote, and accumulates dv += P^T dO and dk += dS^T q in
//   registers.
// Tiles: BM = 64 rows (Dh <= 128) or 32 (Dh <= 256); 256 threads as 16 x
// 16 compute an (BM/16) x (BM/16) block of each score tile and own BM/16
// rows x ceil(Dh/16) columns of the accumulators; every tile lies in
// shared memory as fp32 rows of Dh + 1 floats (conflict-free column
// reads).  Inputs are fp32 or bf16 (q, o, dO in q's dtype; k, v in the kv
// dtype); all arithmetic is fp32 SIMT (expf, no fast math); dq is written
// in q's dtype, dk and dv in the kv dtype.
//
// Bound on the H100: operations.  The gradient needs five products of
// Dh-long dots per live (query, key, head): s, dP, dv, dq and dk -- 10 Dh
// flop -- over O(S Dh) bytes.  This simple design spends 16 Dh: s is
// computed three times (lse pass, dq pass, dkv pass) and dP twice, all as
// fp32 FMAs from shared memory.  Tensor cores (mma.sync / wgmma) and an
// lse kept from K6's forward are the next steps (ROADMAP.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // (B, H, Sq) fp32
  int b, sq, skv, hkv, g, dh;
  long long qsb, qst, qsh;  // q's strides (elements)
  long long ksb, kst, ksh;  // k's and v's strides
  int q_offset, kv_len, causal;
  float scale;
};

// rows [row0, row0 + n_valid) of a (position, dh) slice at row stride rs
// into dst (BM rows of ld floats); rows past n_valid are zero
template <typename T, int BM>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long rs, int n_valid, int dh,
                                          int ld) {
  for (int idx = threadIdx.x; idx < BM * dh; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    dst[r * ld + d] = r < n_valid ? ldf(base + r * rs + d) : 0.f;
  }
}

// acc[r][c] = sum_d A[ty + 16 r][d] * B[tx + 16 c][d]
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* A,
                                         const float* B, int dh, int ld,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A[(ty + 16 * r) * ld + d];
#pragma unroll
    for (int c = 0; c < R; ++c) b[c] = B[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// over the 16 threads of a tile row (lanes sharing ty: one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool live(const Args& a, int kpos, int qpos) {
  return kpos < a.kv_len && (!a.causal || kpos <= qpos);
}

template <typename TQ, typename TKV, int BM>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const Args a) {
  constexpr int R = BM / 16;
  constexpr int ND = (BM == 64 ? 128 : 256) / 16;
  const int ld = a.dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, bb = blockIdx.z;
  const int H = a.hkv * a.g, hk = h / a.g;
  const int nq = min(BM, a.sq - q0);
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + BM * ld;
  float* Ks = dOs + BM * ld;
  float* Vs = Ks + BM * ld;
  float* dSs = Vs + BM * ld;            // BM x (BM + 1)
  float* lse_s = dSs + BM * (BM + 1);
  float* del_s = lse_s + BM;

  const long long orow = (long long)H * a.dh;  // o / dO / dq row stride
  const long long obase = ((long long)bb * a.sq + q0) * orow + (long long)h * a.dh;
  load_rows<TQ, BM>(Qs, (const TQ*)a.q + bb * a.qsb + q0 * a.qst + h * a.qsh,
                    a.qst, nq, a.dh, ld);
  load_rows<TQ, BM>(dOs, (const TQ*)a.dout + obase, orow, nq, a.dh, ld);
  __syncthreads();
  for (int i = warp; i < BM; i += kThreads / 32) {   // D = rowsum(dO * O)
    float s = 0.f;
    if (i < nq) {
      const TQ* orow_p = (const TQ*)a.o + obase + i * orow;
      for (int d = lane; d < a.dh; d += 32) s += dOs[i * ld + d] * ldf(orow_p + d);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) del_s[i] = s;
  }
  __syncthreads();

  const int last_q = a.q_offset + q0 + nq - 1;
  int kv_end = a.causal ? min(a.kv_len, last_q + 1) : a.kv_len;
  kv_end = max(0, min(kv_end, a.skv));
  const int nkb = (kv_end + BM - 1) / BM;
  const TKV* kbase = (const TKV*)a.k + bb * a.ksb + hk * a.ksh;
  const TKV* vbase = (const TKV*)a.v + bb * a.ksb + hk * a.ksh;

  // pass 1: the rows' lse
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { m[r] = -INFINITY; l[r] = 0.f; }
  float s[R][R];
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BM;
    __syncthreads();
    load_rows<TKV, BM>(Ks, kbase + k0 * a.kst, a.kst, min(BM, a.skv - k0),
                       a.dh, ld);
    __syncthreads();
    tile_dot<R>(s, Qs, Ks, a.dh, ld, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + 16 * r;
      const int qpos = a.q_offset + q0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const bool ok = i < nq && live(a, k0 + tx + 16 * c, qpos);
        s[r][c] = ok ? s[r][c] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float ps = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int c = 0; c < R; ++c)
          ps += s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - m_new);
      }
      ps = row_sum(ps);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + 16 * r;
    const float lse = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    if (tx == 0) {
      lse_s[i] = lse;
      if (i < nq) {
        const long long at = ((long long)bb * H + h) * a.sq + q0 + i;
        a.lse[at] = lse;
        a.delta[at] = del_s[i];
      }
    }
  }

  // pass 2: dq
  float acc[R][ND];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  float dp[R][R];
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BM, nk = min(BM, a.skv - k0);
    __syncthreads();
    load_rows<TKV, BM>(Ks, kbase + k0 * a.kst, a.kst, nk, a.dh, ld);
    load_rows<TKV, BM>(Vs, vbase + k0 * a.kst, a.kst, nk, a.dh, ld);
    __syncthreads();
    tile_dot<R>(s, Qs, Ks, a.dh, ld, ty, tx);
    tile_dot<R>(dp, dOs, Vs, a.dh, ld, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + 16 * r;
      const int qpos = a.q_offset + q0 + i;
      const float lse = lse_s[i], del = del_s[i];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int j = tx + 16 * c;
        const bool ok = i < nq && live(a, k0 + j, qpos);
        const float p = ok ? expf(s[r][c] * a.scale - lse) : 0.f;
        dSs[i * (BM + 1) + j] = p * (dp[r][c] - del);
      }
    }
    __syncthreads();
    for (int j = 0; j < BM; ++j) {
      float kv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < a.dh ? Ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ds = dSs[(ty + 16 * r) * (BM + 1) + j];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }
  TQ* dq = (TQ*)a.dq + obase;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + 16 * r;
    if (i >= nq) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < a.dh) dq[i * orow + d] = cvt<TQ>(acc[r][c] * a.scale);
    }
  }
}

template <typename TQ, typename TKV, int BM>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const Args a) {
  constexpr int R = BM / 16;
  constexpr int ND = (BM == 64 ? 128 : 256) / 16;
  const int ld = a.dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BM, hk = blockIdx.y, bb = blockIdx.z;
  const int H = a.hkv * a.g;
  const int nk = min(BM, a.skv - k0);
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + BM * ld;
  float* Qs = Vs + BM * ld;
  float* dOs = Qs + BM * ld;
  float* Ps = dOs + BM * ld;            // BM x (BM + 1), [kv row][q row]
  float* dSs = Ps + BM * (BM + 1);
  float* lse_s = dSs + BM * (BM + 1);
  float* del_s = lse_s + BM;

  float acc_k[R][ND], acc_v[R][ND];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < ND; ++c) { acc_k[r][c] = 0.f; acc_v[r][c] = 0.f; }

  if (k0 < a.kv_len) {                  // keys at or past kv_len: zero
    load_rows<TKV, BM>(Ks, (const TKV*)a.k + bb * a.ksb + k0 * a.kst + hk * a.ksh,
                       a.kst, nk, a.dh, ld);
    load_rows<TKV, BM>(Vs, (const TKV*)a.v + bb * a.ksb + k0 * a.kst + hk * a.ksh,
                       a.kst, nk, a.dh, ld);
    const long long orow = (long long)H * a.dh;
    // the first query that sees key k0
    const int i_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
    float s[R][R], dp[R][R];
    for (int gi = 0; gi < a.g; ++gi) {
      const int h = hk * a.g + gi;
      for (int q0 = i_lo / BM * BM; q0 < a.sq; q0 += BM) {
        const int nq = min(BM, a.sq - q0);
        __syncthreads();
        load_rows<TQ, BM>(Qs, (const TQ*)a.q + bb * a.qsb + q0 * a.qst + h * a.qsh,
                          a.qst, nq, a.dh, ld);
        load_rows<TQ, BM>(dOs, (const TQ*)a.dout +
                          ((long long)bb * a.sq + q0) * orow + (long long)h * a.dh,
                          orow, nq, a.dh, ld);
        for (int i = tid; i < BM; i += kThreads) {
          const long long at = ((long long)bb * H + h) * a.sq + q0 + i;
          lse_s[i] = i < nq ? a.lse[at] : INFINITY;
          del_s[i] = i < nq ? a.delta[at] : 0.f;
        }
        __syncthreads();
        tile_dot<R>(s, Ks, Qs, a.dh, ld, ty, tx);    // [kv row][q row]
        tile_dot<R>(dp, Vs, dOs, a.dh, ld, ty, tx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = ty + 16 * r;
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const int i = tx + 16 * c;
            const bool ok = i < nq && j < nk &&
                            live(a, k0 + j, a.q_offset + q0 + i);
            const float p = ok ? expf(s[r][c] * a.scale - lse_s[i]) : 0.f;
            Ps[j * (BM + 1) + i] = p;
            dSs[j * (BM + 1) + i] = p * (dp[r][c] - del_s[i]);
          }
        }
        __syncthreads();
        for (int i = 0; i < BM; ++i) {
          float qv[ND], dov[ND];
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            const int d = tx + 16 * c;
            qv[c] = d < a.dh ? Qs[i * ld + d] : 0.f;
            dov[c] = d < a.dh ? dOs[i * ld + d] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int j = ty + 16 * r;
            const float p = Ps[j * (BM + 1) + i], ds = dSs[j * (BM + 1) + i];
#pragma unroll
            for (int c = 0; c < ND; ++c) {
              acc_v[r][c] = fmaf(p, dov[c], acc_v[r][c]);
              acc_k[r][c] = fmaf(ds, qv[c], acc_k[r][c]);
            }
          }
        }
      }
    }
  }
  const long long krow = (long long)a.hkv * a.dh;
  const long long kbase = ((long long)bb * a.skv + k0) * krow + (long long)hk * a.dh;
  TKV* dk = (TKV*)a.dk + kbase;
  TKV* dv = (TKV*)a.dv + kbase;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = ty + 16 * r;
    if (j >= nk) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < a.dh) {
        dk[j * krow + d] = cvt<TKV>(acc_k[r][c] * a.scale);
        dv[j * krow + d] = cvt<TKV>(acc_v[r][c]);
      }
    }
  }
}

template <typename TQ, typename TKV, int BM>
int launch_bm(const Args& a, cudaStream_t s) {
  const int ld = a.dh + 1;
  const size_t dq_smem = (size_t)(4 * BM * ld + BM * (BM + 1) + 2 * BM) * 4;
  const size_t dkv_smem =
      (size_t)(4 * BM * ld + 2 * BM * (BM + 1) + 2 * BM) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<TQ, TKV, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv<TQ, TKV, BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_smem);
  if (e != cudaSuccess) return (int)e;
  const int H = a.hkv * a.g;
  flash_bwd_dq<TQ, TKV, BM>
      <<<dim3((a.sq + BM - 1) / BM, H, a.b), kThreads, dq_smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv<TQ, TKV, BM>
      <<<dim3((a.skv + BM - 1) / BM, a.hkv, a.b), kThreads, dkv_smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const Args& a, cudaStream_t s) {
  return a.dh <= 128 ? launch_bm<TQ, TKV, 64>(a, s)
                     : launch_bm<TQ, TKV, 32>(a, s);
}

}  // namespace

// q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) at the given strides (Dh
// contiguous, k and v at equal strides); o, dout, dq contiguous (B, Sq, H,
// Dh); dk, dv contiguous (B, Skv, Hkv, Dh); lse, delta (B, H, Sq) fp32
// scratch (written, then read by the second kernel).  kv_len <= Skv.
extern "C" int tardis_flash_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int b, int sq, int skv, int hkv, int g, int dh, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, int q_offset, int kv_len, int causal, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0 || skv == 0 || hkv == 0 || g == 0)
    return (int)cudaGetLastError();
  if (dh <= 0 || dh > 256 || kv_len > skv) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)delta,
         b, sq, skv, hkv, g, dh, qsb, qst, qsh, ksb, kst, ksh,
         q_offset, kv_len, causal, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(a, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(a, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
