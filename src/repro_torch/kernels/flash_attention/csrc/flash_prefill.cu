// K6 flash_prefill: causal GQA flash-attention forward over a whole prompt
// (or a prompt's suffix against a cache that holds its prefix).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (_flash_kernel).  Semantics kept: query i sits at
// kv position q_offset + i and sees positions t < kv_len (and, causal,
// t <= q_offset + i); scores q.k_t * scale; the softmax runs online in fp32
// as (m, l, acc) with p = 0 wherever the running max is still NEG_INF; the
// output is acc / max(l, 1e-30) in q's dtype, so a row with no live key
// gives 0.  Query head h reads KV head h / G.
//
// Layout: q (B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh) are read where the
// model keeps them -- batch / position / head strides in elements, Dh
// contiguous -- so one layer's (B, T, Hkv, Dh) cache slice is read in
// place.  No transpose, no pad of Dh to 128 (the TPU wrapper's pad would
// read 60 % more at Dh = 80); any Dh <= 256.
//
// Grid: (ceil(Sq * G / 64), Hkv, B).  A CTA owns 64 (query, head) rows of
// ONE KV head: the flat row f = qi * G + g walks the G query heads of that
// KV head for consecutive queries (8 queries x 8 heads at tinyllama's
// G = 8, 64 queries at zamba2's G = 1), so every K/V tile it stages is
// used by all G heads.  It walks 64-position KV tiles only up to
// min(kv_len, q_offset + its last query + 1): tiles past the causal
// diagonal or past kv_len are never loaded, and the ragged Sq / Skv edges
// are masked in the kernel (the TPU kernel asserted that the lengths
// divide by its block).  Per tile: K and V go to shared memory as fp32
// rows of Dh + 1 floats (conflict-free column reads); 256 threads as
// 16 x 16 compute a 4 x 4 block of the 64 x 64 scores each; the row max
// and sum run over the 16 threads of a row with shuffles; P goes to
// shared memory and each thread accumulates its 4 rows x ceil(Dh / 16)
// output columns in registers.
//
// The bf16 pair (Dh a multiple of 16 up to 128, K/V rows in 16-byte
// vectors) runs on the tensor cores instead: flash_prefill_mma, 4 warps
// of 16 rows each, mma.sync m16n8k16 bf16 -> fp32 for Q.K^T (exact: bf16
// products accumulate in fp32) and for P.V.  P is rounded to bf16 for
// P.V, as FlashAttention does, while l sums the fp32 P: each weight is off
// by at most 2^-9 of itself, so the output is off the plain version's by
// at most 2^-9 max|v| before its own rounding to bf16.  The softmax is the
// plain version's: expf(s * scale - m).  Q stays in registers as A
// fragments; K/V tiles are copied with cp.async into two shared-memory
// buffers (the next tile lands while this one is computed) as [key][d]
// rows padded by 16 bytes, so K's fragment loads and V's ldmatrix.trans
// hit 32 banks.  CTAs are issued longest-first (the last query rows walk
// the most tiles).
//
// Bound on the H100: operations.  At S = 3072 a (b, kv head) pair does
// ~S^2 * Dh * G * 2 multiply-adds over ~S * Dh * 4 bytes of K/V: hundreds
// of flop per byte.  The fp32 pair runs its products as fp32 SIMT FMAs
// (67 TFLOP/s peak; no TF32, the fp32 tolerance is 2e-4), and so does a
// float32 q over bfloat16 K/V.  mma.sync reaches only part of the bf16
// tensor-core peak that wgmma would (989 TFLOP/s); wgmma and TMA are for
// a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kTile = 64;      // KV positions per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPld = kTile + 1;
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

// max / sum over the 16 lanes that share a row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DC: output columns per thread, ceil(dh / 16)
template <typename TQ, typename TKV, int DC>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, TQ* __restrict__ out, int sq, int hkv, int g,
    int dh, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, int q_offset, int kv_len, int causal,
    float scale) {
  const int b = blockIdx.z, hk = blockIdx.y;
  const long long n_rows = static_cast<long long>(sq) * g;
  const long long f0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long f_last = min(f0 + kRows, n_rows) - 1;
  const int h = hkv * g;
  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + static_cast<int>(f_last / g) + 1);

  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;               // kRows x ld
  float* ks = qs + kRows * ld;    // kTile x ld
  float* vs = ks + kTile * ld;    // kTile x ld
  float* ps = vs + kTile * ld;    // kRows x kPld

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int x = tid; x < kRows * dh; x += kThreads) {
    const int r = x / dh, d = x - r * dh;
    const long long f = f0 + r;
    float val = 0.f;
    if (f < n_rows) {
      const long long qi = f / g;
      const int gi = static_cast<int>(f - qi * g);
      val = to_f32(q[b * qsb + qi * qst + (hk * g + gi) * qsh + d]);
    }
    qs[r * ld + d] = val;
  }

  int qpos[4];
  bool live_row[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = f0 + ty * 4 + i;
    live_row[i] = f < n_rows;
    qpos[i] = q_offset + static_cast<int>((live_row[i] ? f : f0) / g);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const TKV* kb = k + b * ksb + hk * ksh;
  const TKV* vb = v + b * ksb + hk * ksh;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    const int n_t = min(kTile, kv_end - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int x = tid; x < kTile * dh; x += kThreads) {
      const int t = x / dh, d = x - t * dh;
      float kv_k = 0.f, kv_v = 0.f;
      if (t < n_t) {
        const long long off = (t0 + t) * kst + d;
        kv_k = to_f32(kb[off]);
        kv_v = to_f32(vb[off]);
      }
      ks[t * ld + d] = kv_k;
      vs[t * ld + d] = kv_v;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qr = qs + ty * 4 * ld;
    const float* kr = ks + tx * ld;
    for (int d = 0; d < dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qr[i * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kr[j * 16 * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = t0 + tx + 16 * j;
        const bool live = live_row[i] && pos < kv_len &&
                          (!causal || pos <= qpos[i]);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new <= kNegInf ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const float* pr = ps + ty * 4 * kPld;
    for (int t = 0; t < n_t; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pr[i * kPld + t];
      const float* vr = vs + t * ld;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < dh ? vr[d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live_row[i]) continue;
    const long long f = f0 + ty * 4 + i;
    const long long qi = f / g;
    const int gi = static_cast<int>(f - qi * g);
    TQ* orow = out + ((static_cast<long long>(b) * sq + qi) * h
                      + hk * g + gi) * dh;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) orow[d] = from_f32<TQ>(acc[i][c] * inv);
    }
  }
}

// ---- the tensor-core variant for the bf16 pair ---------------------------

constexpr int kMmaWarps = 4;             // 16 rows each: kRows rows a CTA
constexpr int kMmaThreads = 32 * kMmaWarps;

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_pair(const __nv_bfloat16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
         (static_cast<unsigned>(__bfloat16_as_ushort(p[1])) << 16);
}
// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, transposed: thread t gives
// the row address of matrix t / 8 and receives, of matrix i in r[i], the
// elements (2 (t % 4), t / 4) and (2 (t % 4) + 1, t / 4)
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
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

template <int DH> constexpr int mma_smem_bytes() {
  return 2 * 2 * kTile * (DH + 8) * 2;   // 2 buffers x (K, V) x bf16
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_prefill_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int sq, int hkv, int g, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, int q_offset, int kv_len,
    int causal, float scale) {
  constexpr int KS = DH / 16;            // k-steps of Q.K^T
  constexpr int NB = DH / 8;             // 8-wide column blocks of the output
  constexpr int LD = DH + 8;             // [key][d] row, bf16 (+16 bytes)
  constexpr int kVecs = kTile * DH / 8;  // 16-byte vectors in a K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vbuf = kbuf + 2 * kTile * LD;   // 2 buffers each

  const int b = blockIdx.z, hk = blockIdx.y;
  const int h = hkv * g;
  const long long n_rows = static_cast<long long>(sq) * g;
  const long long f0 =
      static_cast<long long>(gridDim.x - 1 - blockIdx.x) * kRows;
  const long long f_last = min(f0 + kRows, n_rows) - 1;
  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + static_cast<int>(f_last / g) + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * ksb + hk * ksh;

  // issue the copies of tile [t0, t0 + 64) into buffer buf
  auto load_tile = [&](int buf, int t0) {
    const int n_t = min(kTile, kv_end - t0);
    __nv_bfloat16* kd = kbuf + buf * kTile * LD;
    __nv_bfloat16* vd = vbuf + buf * kTile * LD;
    for (int x = tid; x < kVecs; x += kMmaThreads) {
      const int t = x / (DH / 8), d = (x - t * (DH / 8)) * 8;
      const bool full = t < n_t;
      const long long off = full ? (t0 + t) * kst + d : 0;
      cp_async16(kd + t * LD + d, kb + off, full);
      cp_async16(vd + t * LD + d, vb + off, full);
    }
  };
  if (kv_end > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's two fragment rows: r = grp and grp + 8 of the warp's 16
  long long f[2];
  bool live_row[2];
  int qpos[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    f[u] = f0 + warp * 16 + grp + 8 * u;
    live_row[u] = f[u] < n_rows;
    const long long ff = live_row[u] ? f[u] : f0;
    const long long qi = ff / g;
    const int gi = static_cast<int>(ff - qi * g);
    qpos[u] = q_offset + static_cast<int>(qi);
    qrow[u] = q + b * qsb + qi * qst + (hk * g + gi) * qsh;
  }
  unsigned qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + tig * 2;
    qf[s][0] = live_row[0] ? pack_pair(qrow[0] + c) : 0u;
    qf[s][1] = live_row[1] ? pack_pair(qrow[1] + c) : 0u;
    qf[s][2] = live_row[0] ? pack_pair(qrow[0] + c + 8) : 0u;
    qf[s][3] = live_row[1] ? pack_pair(qrow[1] + c + 8) : 0u;
  }

  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t0 = 0, buf = 0; t0 < kv_end; t0 += kTile, buf ^= 1) {
    const int n_t = min(kTile, kv_end - t0);
    if (t0 + kTile < kv_end) load_tile(buf ^ 1, t0 + kTile);
    cp_async_commit();
    cp_async_wait1();          // this tile's copies have landed
    __syncthreads();
    const __nv_bfloat16* kt = kbuf + buf * kTile * LD;
    const __nv_bfloat16* vt = vbuf + buf * kTile * LD;

    // S = Q . K^T for the warp's 16 rows x 64 keys: 8 blocks of 8 keys
    float sc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
      const __nv_bfloat16* kr = kt + (nb * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        mma_bf16(sc[nb], qf[s],
                 *reinterpret_cast<const unsigned*>(kr + s * 16),
                 *reinterpret_cast<const unsigned*>(kr + s * 16 + 8));
    }

    // mask, online softmax over the two rows this thread holds
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = t0 + nb * 8 + tig * 2 + e;
          const bool live = live_row[u] && pos < kv_len &&
                            (!causal || pos <= qpos[u]);
          float& x = sc[nb][2 * u + e];
          x = live ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[u], mx);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nb][2 * u + e];
          x = m_new <= kNegInf ? 0.f : expf(x - m_new);
          sum += x;
        }
      sum = quad_sum(sum);
      const float alpha = expf(m[u] - m_new);
      l[u] = l[u] * alpha + sum;
      m[u] = m_new;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        o[n][2 * u] *= alpha;
        o[n][2 * u + 1] *= alpha;
      }
    }

    // O += P . V over 16-key steps; P rounded to bf16 as the A fragment,
    // V as B fragments through ldmatrix.trans of its [key][d] rows
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s * 16 >= n_t) break;
      const unsigned pa[4] = {
          as_u32(__floats2bfloat162_rn(sc[2 * s][0], sc[2 * s][1])),
          as_u32(__floats2bfloat162_rn(sc[2 * s][2], sc[2 * s][3])),
          as_u32(__floats2bfloat162_rn(sc[2 * s + 1][0], sc[2 * s + 1][1])),
          as_u32(__floats2bfloat162_rn(sc[2 * s + 1][2], sc[2 * s + 1][3]))};
      const __nv_bfloat16* vrow =
          vt + (s * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
          8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vrow + n * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!live_row[u]) continue;
    const long long qi = f[u] / g;
    const int gi = static_cast<int>(f[u] - qi * g);
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * sq + qi) * h
                                 + hk * g + gi) * DH;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8 + tig * 2) = as_u32(
          __floats2bfloat162_rn(o[n][2 * u] * inv, o[n][2 * u + 1] * inv));
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int hkv, int g, long long qsb, long long qst,
               long long qsh, long long ksb, long long kst, long long ksh,
               int q_offset, int kv_len, int causal, float scale,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<DH>();
  auto kern = flash_prefill_mma<DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_rows = static_cast<long long>(sq) * g;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), hkv, b);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, sq, hkv, g, qsb, qst,
      qsh, ksb, kst, ksh, q_offset, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

// The bf16 pair on the tensor cores where Dh is a multiple of 16 up to
// 128 and the K/V rows are whole 16-byte vectors; -1 when it does not
// apply (the SIMT kernel takes the call).
int try_mma(const void* q, const void* k, const void* v, void* out, int b,
            int sq, int hkv, int g, int dh, long long qsb, long long qst,
            long long qsh, long long ksb, long long kst, long long ksh,
            int q_offset, int kv_len, int causal, float scale,
            cudaStream_t s) {
  if (dh % 16 || dh > 128 || ksb % 8 || kst % 8 || ksh % 8 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return -1;
#define TARDIS_MMA(D)                                                      \
  case D:                                                                  \
    return launch_mma<D>(q, k, v, out, b, sq, hkv, g, qsb, qst, qsh, ksb,  \
                         kst, ksh, q_offset, kv_len, causal, scale, s);
  switch (dh) {
    TARDIS_MMA(16) TARDIS_MMA(32) TARDIS_MMA(48) TARDIS_MMA(64)
    TARDIS_MMA(80) TARDIS_MMA(96) TARDIS_MMA(112) TARDIS_MMA(128)
  }
#undef TARDIS_MMA
  return -1;
}

template <typename TQ, typename TKV, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int hkv, int g, int dh, long long qsb, long long qst,
              long long qsh, long long ksb, long long kst, long long ksh,
              int q_offset, int kv_len, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kRows + 2 * kTile) * (dh + 1) + kRows * kPld);
  auto kern = flash_prefill_kernel<TQ, TKV, DC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_rows = static_cast<long long>(sq) * g;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (TQ*)out, sq, hkv, g, dh,
      qsb, qst, qsh, ksb, kst, ksh, q_offset, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int hkv, int g, int dh, long long qsb, long long qst,
           long long qsh, long long ksb, long long kst, long long ksh,
           int q_offset, int kv_len, int causal, float scale,
           cudaStream_t s) {
  if (dh <= 64)
    return launch_dc<TQ, TKV, 4>(q, k, v, out, b, sq, hkv, g, dh, qsb, qst,
                                 qsh, ksb, kst, ksh, q_offset, kv_len,
                                 causal, scale, s);
  if (dh <= 80)
    return launch_dc<TQ, TKV, 5>(q, k, v, out, b, sq, hkv, g, dh, qsb, qst,
                                 qsh, ksb, kst, ksh, q_offset, kv_len,
                                 causal, scale, s);
  if (dh <= 128)
    return launch_dc<TQ, TKV, 8>(q, k, v, out, b, sq, hkv, g, dh, qsb, qst,
                                 qsh, ksb, kst, ksh, q_offset, kv_len,
                                 causal, scale, s);
  return launch_dc<TQ, TKV, 16>(q, k, v, out, b, sq, hkv, g, dh, qsb, qst,
                                qsh, ksb, kst, ksh, q_offset, kv_len, causal,
                                scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q (B, Sq, H, Dh) at strides
// (qsb, qst, qsh) and out (B, Sq, H, Dh) contiguous, both in q_dtype; k and
// v (B, Skv, Hkv, Dh) at the shared strides (ksb, kst, ksh) in kv_dtype:
// both float32, both bfloat16, or a float32 q over bfloat16 K/V.  Dh is
// contiguous everywhere.  kv_len <= Skv (the wrapper clamps it).
extern "C" int tardis_flash_prefill(
    const void* q, const void* k, const void* v, void* out, int b, int sq,
    int hkv, int g, int dh, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, int q_offset, int kv_len,
    int causal, float scale, int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  if (dh <= 0 || dh > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, out, b, sq, hkv, g, dh, qsb, qst,
                                qsh, ksb, kst, ksh, q_offset, kv_len, causal,
                                scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, out, b, sq, hkv, g, dh, qsb,
                                        qst, qsh, ksb, kst, ksh, q_offset,
                                        kv_len, causal, scale, s);
  if (q_dtype == 1 && kv_dtype == 1) {
    const int r = try_mma(q, k, v, out, b, sq, hkv, g, dh, qsb, qst, qsh,
                          ksb, kst, ksh, q_offset, kv_len, causal, scale, s);
    if (r >= 0) return r;
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, b, sq, hkv, g, dh, qsb, qst, qsh, ksb, kst, ksh,
        q_offset, kv_len, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
