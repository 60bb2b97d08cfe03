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
// Three variants, chosen by the wrapper (kernel.py: pick_variant) and
// passed in; a variant that cannot take the call returns an error -- no
// quiet fallback to another:
// * "tf32x3" (flash_prefill_tf32.cu): an fp32 q over fp32 or
//   bf16 K/V, Dh <= 128 -- every product as three TF32 products on
//   mma.sync.  The training path and the fp32 serving lanes run it.
// * "wgmma" (below): the bf16 pair on TMA + wgmma.
// * "simt": what neither takes -- Dh > 128, a bf16 Dh that is not a
//   multiple of 16, a bf16 view TMA cannot map.
//
// The SIMT kernel: grid (ceil(Sq * G / 64), Hkv, B).  A CTA owns
// 64 (query, head) rows of ONE KV head: the flat row f = qi * G + g walks
// the G query heads of that KV head for consecutive queries (8 queries x
// 8 heads at tinyllama's G = 8, 64 queries at zamba2's G = 1), so every
// K/V tile it stages is used by all G heads (so do the other variants'
// CTAs).  It walks 64-position KV tiles only up to
// min(kv_len, q_offset + its last query + 1): tiles past the causal
// diagonal or past kv_len are never loaded, and the ragged Sq / Skv edges
// are masked in the kernel (the TPU kernel asserted that the lengths
// divide by its block).  Per tile: K and V go to shared memory as fp32
// rows of Dh + 1 floats (conflict-free column reads); 256 threads as
// 16 x 16 compute a 4 x 4 block of the 64 x 64 scores each; the row max
// and sum run over the 16 threads of a row with shuffles; P goes to
// shared memory and each thread accumulates its 4 rows x ceil(Dh / 16)
// output columns in registers.

// The bf16 pair (Dh a multiple of 16 up to 128, K/V views in whole
// 16-byte rows) runs flash_prefill_wgmma on the tensor cores instead.
// P is rounded to bf16 for P.V, as FlashAttention does, while l sums the
// fp32 P: each weight is off by at most 2^-9 of itself, so the output is
// off the plain version's by at most 2^-9 max|v| before its own rounding
// to bf16.  Q.K^T is exact (bf16 products accumulate in fp32).
//
// Bound on the H100: operations.  At S = 3072 a (b, kv head) pair does
// ~S^2 * Dh * G * 2 multiply-adds over ~S * Dh * 4 bytes of K/V: hundreds
// of flop per byte.  The SIMT kernel runs its products as fp32 FMAs
// (67 TFLOP/s peak; no TF32, the fp32 tolerance is 2e-4); it ran both
// fp32-q pairs before the tf32x3 variant (1221.73 us at the training
// shape on an H100, 21 % of that bound's speed).  The first bf16 design reached 13 % of the
// bf16 tensor-core peak (989 TFLOP/s): mma.sync on 64-row CTAs, a
// two-buffer cp.async ring with two CTA barriers a tile, the causal /
// kv_len mask evaluated on every element of every tile, expf with the
// scale applied per element.
//
// The Hopper design (flash_prefill_wgmma): 384 threads, 128 (query, head)
// rows a CTA.
// * Warpgroup 0 is the producer: setmaxnreg gives its registers to the
//   consumers and one thread keeps a kRing-deep ring of 64-position K/V
//   tiles in flight with TMA (cp.async.bulk.tensor over a (Dh, Hkv, T, B)
//   tensor map of the view, built per call because every layer's view
//   has its own base; full / empty mbarriers).  Positions at or past
//   kv_len and columns past Dh arrive as zeros.
// * Warpgroups 1 and 2 each own 64 rows.  S = Q.K^T is one wgmma
//   m64n64k16 per 16 columns of Dh, Q and K both read from shared memory
//   by descriptor.  O += P.V is wgmma with P as the register A operand:
//   the fp32 S fragments of 16 keys are converted in place to bf16 pairs,
//   which is exactly the A fragment layout (as FlashAttention-3 does);
//   V's [key][d] rows are the B operand through the descriptor's
//   transpose bit.  The two warpgroups' softmax and products interleave
//   on the SM's schedulers.
// * Shared-memory layout: every tile row is 128 bytes of one 64-column
//   "atom" in TMA's 128-byte swizzle; Dh > 64 takes two atoms.  Dh = 80
//   (zamba2, 160-byte rows, which no single 128-byte swizzle atom fits)
//   is one full atom and one of 16 columns whose other 48 are TMA's zero
//   fill: Q.K^T runs 5 k-steps (none on the fill), P.V one n64 and one
//   n16 instruction.  Q is loaded once by the consumers themselves (any
//   G, any q strides) into the same swizzled layout.
// * The softmax runs in base 2 with scale * log2(e) folded in once; the
//   causal / kv_len mask runs only on tiles that cross kv_len or the
//   diagonal of the warpgroup's first row.
// * CTAs are issued longest-first (the last query rows walk the most
//   tiles).
// A view TMA cannot map (a stride TMA refuses) takes the SIMT kernel (the
// wrapper checks the strides and alignment TMA needs).
//
// The LSE for the backward (K10): given a non-null `lse`, every variant
// also write each query row's log-sum-exp of its live scaled scores,
// m * scale + log(l) from the row's running max and sum (fp32, (B, H,
// Sq)), +inf on a row with no live key (l = 0), so that K10 need not
// recompute it.  The serving paths pass null: nothing more is written.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
    const TKV* __restrict__ v, TQ* __restrict__ out,
    float* __restrict__ lse, int sq, int hkv, int g, int dh, long long qsb, long long qst, long long qsh, long long ksb,
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
    if (lse && tx == 0)   // m is in scaled units here
      lse[(static_cast<long long>(b) * h + hk * g + gi) * sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// ---- helpers of the bf16 variant --------------------------------------

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_pair(const __nv_bfloat16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
         (static_cast<unsigned>(__bfloat16_as_ushort(p[1])) << 16);
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

// ---- the Hopper variant for the bf16 pair: TMA + wgmma --------------------

constexpr int kWgRows = 64;                 // rows per consumer warpgroup
constexpr int kCtaRows = 2 * kWgRows;       // two consumer warpgroups
constexpr int kKvTile = 64;                 // KV positions per tile
// K/V tiles in flight: as many as fit beside Q in 227 KB of shared
// memory (8 of 16 KB for Dh <= 64; 6 of 32 KB above)
template <int NA> __host__ __device__ constexpr int ring_depth() {
  return NA == 1 ? 8 : 6;
}
constexpr int kWgThreads = 3 * 128;         // producer + 2 consumers
constexpr int kAtom = kKvTile * 128;        // a 64-row tile of one atom
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 2^x in one MUFU.EX2 (exp2f adds range checks around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// A wgmma shared-memory descriptor of a tile of 128-byte rows in the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B; rows 1024-byte
// aligned in groups of 8): start address >> 4, both byte offsets 1024
// (the 8-row group stride; with at most 64 columns an instruction reads
// no other stride), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival for the warp, once all its lanes are past this point
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(n)
               : "memory");
}
// one TMA box of the (Dh, Hkv, T, B) map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers in place around the asynchronous wgmma: no read moves
// above a wait, no write below a fence
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(unsigned (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// d (64 x 64, fp32) {+}= A (64 x 16, smem desc) . B (64 x 16, smem desc)^T;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 registers) . B (16 x 16, smem
// desc, N contiguous: transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) . B (16 x 32, smem
// desc, N contiguous: transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 48, fp32) += A (64 x 16, bf16 registers) . B (16 x 48, smem
// desc, N contiguous: transposed)
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, smem
// desc, N contiguous: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2 > 0 ? N / 2 : 1],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
}

template <int DH>
constexpr int wgmma_smem_bytes() {
  constexpr int NA = (DH + 63) / 64;
  return 1024 + NA * kCtaRows * 128 + ring_depth<NA>() * 2 * NA * kAtom;
}

// Grid: one CTA per (128-row block, b, kv head), the (b, kv head) pairs
// fastest so that neighbouring CTAs read different K/V, the row blocks
// longest-first; 384 threads: warpgroup 0 is the producer (one thread
// issues the TMA loads), warpgroups 1 and 2 each own 64 (query, head)
// rows.
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1) flash_prefill_wgmma(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int bsz, int sq, int hkv, int g, long long qsb,
    long long qst, long long qsh, int q_vec, int q_offset, int kv_len,
    int causal, float scale, float scale2) {
  constexpr int NA = (DH + 63) / 64;        // 64-column atoms of a row
  constexpr int kRing = ring_depth<NA>();
  constexpr int KS = DH / 16;               // k-steps of Q.K^T
  constexpr int N0 = DH < 64 ? DH : 64;     // P.V columns in atom 0
  constexpr int N1 = DH - N0;               // ... and in atom 1
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;                         // [NA][128 rows][128 B]
  unsigned char* ks = qs + NA * kCtaRows * 128;     // [kRing][NA][64][128 B]
  unsigned char* vs = ks + kRing * NA * kAtom;      // [kRing][NA][64][128 B]
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];

  const int pairs = bsz * hkv, pair = blockIdx.x % pairs;
  const int b = pair / hkv, hk = pair - b * hkv;
  const long long n_rows = static_cast<long long>(sq) * g;
  const long long f0 = static_cast<long long>(
      gridDim.x / pairs - 1 - blockIdx.x / pairs) * kCtaRows;
  const long long f_last = min(f0 + kCtaRows, n_rows) - 1;
  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + static_cast<int>(f_last / g) + 1);
  const int n_tiles = (max(kv_end, 0) + kKvTile - 1) / kKvTile;
  // the warpgroup index through a shuffle, so that the compiler sees it
  // (and all that follows from it) as warp-uniform: a wgmma on a path it
  // takes for divergent is serialized (ptxas C7518)
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);          // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                            // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kRing;
        mbar_wait(&empty[s], ((j / kRing) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * NA * kAtom);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load(ks + (s * NA + a) * kAtom, &kmap, &full[s], a * 64, hk,
                   j * kKvTile, b);
          tma_load(vs + (s * NA + a) * kAtom, &vmap, &full[s], a * 64, hk,
                   j * kKvTile, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, ct = tid & 127;
  const int warp = ct >> 5, lane = ct & 31, grp = lane >> 2, tig = lane & 3;
  const long long fw = f0 + cw * kWgRows;   // the warpgroup's first row

  // Q: the warpgroup's 64 rows into the swizzled atoms (16-byte chunk c
  // of row r at chunk c ^ (r % 8)), zeros past Sq * G and Dh
  for (int x = ct; x < kWgRows * NA * 8; x += 128) {
    const int rr = x / (NA * 8), a = (x / 8) % NA, c = x % 8;
    const int d0 = a * 64 + c * 8;
    const long long f = fw + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (f < n_rows && d0 < DH) {
      const long long qi = f / g;
      const int gi = static_cast<int>(f - qi * g);
      const __nv_bfloat16* src = q + b * qsb + qi * qst + (hk * g + gi) * qsh +
                                 d0;
      if (q_vec) {
        val = *reinterpret_cast<const uint4*>(src);
      } else {
        val.x = pack_pair(src);
        val.y = pack_pair(src + 2);
        val.z = pack_pair(src + 4);
        val.w = pack_pair(src + 6);
      }
    }
    *reinterpret_cast<uint4*>(qs + a * kCtaRows * 128 +
                              (cw * kWgRows + rr) * 128 +
                              ((c ^ (rr & 7)) << 4)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

  // this thread's two rows (warp * 16 + grp and + 8 of the warpgroup's)
  int qpos[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long f = fw + warp * 16 + grp + 8 * u;
    qpos[u] = q_offset + static_cast<int>((f < n_rows ? f : fw) / g);
  }
  // the warpgroup's own KV limit, and the first position any of its
  // rows cannot see (tiles below it need no causal mask)
  int kv_end_w = 0, q_first = 0;
  if (fw < n_rows) {
    kv_end_w = kv_len;
    if (causal)
      kv_end_w = min(kv_end_w, q_offset + static_cast<int>(
                                   min(fw + kWgRows, n_rows) - 1) / g + 1);
    q_first = q_offset + static_cast<int>(fw / g);
  }
  const int n_tiles_w = __shfl_sync(
      0xffffffffu, (max(kv_end_w, 0) + kKvTile - 1) / kKvTile, 0);
  q_first = __shfl_sync(0xffffffffu, q_first, 0);

  float o0[N0 / 2], o1[N1 / 2 > 0 ? N1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (N1 / 2 > 0 ? N1 / 2 : 1); ++i) o1[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  unsigned pa[4][4];                        // P of the previous tile, bf16
  float sc[32];                             // S of this tile, then its P
  const unsigned q_addr = smem_u32(qs) + cw * kWgRows * 128;

  // S = Q.K^T of tile j (64 rows x 64 keys, fp32), not waited for
  auto issue_s = [&](int j) {
    const int s = j % kRing;
#pragma unroll
    for (int k = 0; k < KS; ++k)
      wgmma_ss_n64(sc,
                   desc_sw128(q_addr + (k / 4) * kCtaRows * 128 +
                              (k % 4) * 32),
                   desc_sw128(smem_u32(ks + (s * NA + k / 4) * kAtom) +
                              (k % 4) * 32),
                   k > 0);
    wg_commit();
  };
  // O += P.V of tile jp: P rounded to bf16 as the register A operand (the
  // S fragments of 16 keys are exactly its layout), V's [key][d] rows as
  // the transposed B operand, one instruction per 64-column atom
  auto issue_pv = [&](int jp) {
    const int sp = jp % kRing;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<N0>(o0, pa[kk],
                   desc_sw128(smem_u32(vs + sp * NA * kAtom) + kk * 2048));
      if constexpr (N1 > 0)
        wgmma_pv<N1>(o1, pa[kk],
                     desc_sw128(smem_u32(vs + (sp * NA + 1) * kAtom) +
                                kk * 2048));
    }
    wg_commit();
  };
  // the online softmax of tile j in base 2 on the raw scores in sc, the
  // scale * log2(e) folded into one FMA.  Two instances: an edge tile
  // (one that crosses kv_len or the causal diagonal of the warpgroup's
  // first row) is masked; an inner tile, every key of which every row
  // sees, runs no mask arithmetic at all and has a finite row max.
  // Leaves P in sc and each row's rescale factor in alpha.
  float alpha[2];
  auto softmax = [&](int j, auto edge_tag) {
    constexpr bool edge = decltype(edge_tag)::value;
    const int t0 = j * kKvTile;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nb * 4 + 2 * u + e];
          if constexpr (edge) {
            const int pos = t0 + nb * 8 + tig * 2 + e;
            if (pos >= kv_len || (causal && pos > qpos[u])) x = kNegInf;
          }
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[u], mx);
      const float off = -m_new * scale2;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nb * 4 + 2 * u + e];
          if constexpr (edge)
            x = m_new <= kNegInf ? 0.f : ex2(fmaf(x, scale2, off));
          else
            x = ex2(fmaf(x, scale2, off));
          sum += x;
        }
      alpha[u] = ex2((m[u] - m_new) * scale2);
      l[u] = l[u] * alpha[u] + quad_sum(sum);
      m[u] = m_new;
    }
  };
  auto softmax_tile = [&](int j) {
    const int t0 = j * kKvTile;
    if (t0 + kKvTile > kv_len || (causal && t0 + kKvTile - 1 > q_first))
      softmax(j, std::true_type{});
    else
      softmax(j, std::false_type{});
  };
  // rescale O by alpha, then P to bf16 A fragments
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int nb = 0; nb < N0 / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) o0[nb * 4 + 2 * u + e] *= alpha[u];
#pragma unroll
      for (int nb = 0; nb < N1 / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) o1[nb * 4 + 2 * u + e] *= alpha[u];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // Tile j's S is issued together with tile j - 1's P.V, so the softmax
  // of tile j runs while the tensor cores finish P.V; a tile's buffers are
  // released (one arrival a warp) once its P.V is done.  Registers the
  // wgmmas read or write are fenced only before a stage's wgmma.fence and
  // after its last wait, never in between (else ptxas serializes them).
  if (n_tiles_w > 0) {
    mbar_wait(&full[0], 0);
    wg_fence();
    issue_s(0);
    wg_wait<0>();
    reg_fence(sc);
    softmax_tile(0);
    rescale_and_pack();
  }
  for (int j = 1; j < n_tiles_w; ++j) {
    mbar_wait(&full[j % kRing], (j / kRing) & 1);
    reg_fence(pa);
    reg_fence(o0);
    reg_fence(o1);
    wg_fence();
    issue_s(j);
    issue_pv(j - 1);
    wg_wait<1>();                           // S is done, P.V may run on
    reg_fence(sc);
    softmax_tile(j);
    wg_wait<0>();
    reg_fence(o0);
    reg_fence(o1);
    mbar_arrive_warp(&empty[(j - 1) % kRing]);
    rescale_and_pack();
  }
  if (n_tiles_w > 0) {                      // the last tile's P.V
    reg_fence(pa);
    reg_fence(o0);
    reg_fence(o1);
    wg_fence();
    issue_pv(n_tiles_w - 1);
    wg_wait<0>();
    reg_fence(o0);
    reg_fence(o1);
    mbar_arrive_warp(&empty[(n_tiles_w - 1) % kRing]);
  }
  for (int j = n_tiles_w; j < n_tiles; ++j) {   // past this warpgroup's rows
    mbar_wait(&full[j % kRing], (j / kRing) & 1);
    mbar_arrive_warp(&empty[j % kRing]);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long f = fw + warp * 16 + grp + 8 * u;
    if (f >= n_rows) continue;
    const long long qi = f / g;
    const int gi = static_cast<int>(f - qi * g);
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * sq + qi) * g *
                                     hkv + hk * g + gi) * DH;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
    if (lse && tig == 0)  // m is in raw score units here
      lse[(static_cast<long long>(b) * g * hkv + hk * g + gi) * sq + qi] =
          l[u] > 0.f ? m[u] * scale + logf(l[u]) : INFINITY;
#pragma unroll
    for (int nb = 0; nb < N0 / 8; ++nb)
      *reinterpret_cast<unsigned*>(orow + nb * 8 + tig * 2) =
          pack_bf16(o0[nb * 4 + 2 * u] * inv, o0[nb * 4 + 2 * u + 1] * inv);
#pragma unroll
    for (int nb = 0; nb < N1 / 8; ++nb)
      *reinterpret_cast<unsigned*>(orow + 64 + nb * 8 + tig * 2) =
          pack_bf16(o1[nb * 4 + 2 * u] * inv, o1[nb * 4 + 2 * u + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (the
// library links no libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The (Dh, Hkv, T, B) map of a K or V view, boxes of 64 columns x 64
// positions of one (b, kv head) in the 128-byte swizzle; positions at or
// past kv_len, columns past Dh read as zeros.  False where TMA cannot
// take the view.
bool kv_map(CUtensorMap* map, const void* base, int dh, int hkv, int t,
            int b, long long sh, long long st, long long sb) {
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)hkv, (cuuint64_t)t,
                        (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 1, kKvTile, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int sq, int hkv, int g, long long qsb,
                 long long qst, long long qsh, long long ksb, long long kst,
                 long long ksh, int q_offset, int kv_len, int causal,
                 float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  const int t = kv_len > 0 ? kv_len : 1;
  if (!kv_map(&kmap, k, DH, hkv, t, b, ksh, kst, ksb) ||
      !kv_map(&vmap, v, DH, hkv, t, b, ksh, kst, ksb))
    return -1;
  constexpr int smem = wgmma_smem_bytes<DH>();
  auto kern = flash_prefill_wgmma<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int q_vec = qsb % 8 == 0 && qst % 8 == 0 && qsh % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const long long n_rows = static_cast<long long>(sq) * g;
  const long long n_ctas = (n_rows + kCtaRows - 1) / kCtaRows * b * hkv;
  kern<<<(unsigned)n_ctas, kWgThreads, smem, stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, lse, b, sq,
      hkv, g, qsb, qst, qsh, q_vec, q_offset, kv_len, causal, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// The bf16 pair on TMA + wgmma where Dh is a multiple of 16 up to 128 and
// the K/V views are whole 16-byte rows TMA takes; -1 when it does not
// apply (the wrapper picks the SIMT kernel for such a call, so -1 here is
// an error).
int try_wgmma(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int sq, int hkv, int g, int dh,
              long long qsb, long long qst, long long qsh, long long ksb,
              long long kst, long long ksh, int q_offset, int kv_len,
              int causal, float scale, cudaStream_t s) {
  if (dh % 16 || dh > 128 || ksb % 8 || kst % 8 || ksh % 8 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return -1;
#define TARDIS_WGMMA(D)                                                      \
  case D:                                                                    \
    return launch_wgmma<D>(q, k, v, out, lse, b, sq, hkv, g, qsb, qst, qsh,  \
                           ksb, kst, ksh, q_offset, kv_len, causal, scale,  \
                           s);
  switch (dh) {
    TARDIS_WGMMA(16) TARDIS_WGMMA(32) TARDIS_WGMMA(48) TARDIS_WGMMA(64)
    TARDIS_WGMMA(80) TARDIS_WGMMA(96) TARDIS_WGMMA(112) TARDIS_WGMMA(128)
  }
#undef TARDIS_WGMMA
  return -1;
}

template <typename TQ, typename TKV, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int sq, int hkv, int g, int dh,
              long long qsb, long long qst, long long qsh, long long ksb,
              long long kst, long long ksh, int q_offset, int kv_len,
              int causal, float scale, cudaStream_t stream) {
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
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (TQ*)out, lse, sq, hkv, g,
      dh, qsb, qst, qsh, ksb, kst, ksh, q_offset, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int hkv, int g, int dh, long long qsb,
           long long qst, long long qsh, long long ksb, long long kst,
           long long ksh, int q_offset, int kv_len, int causal, float scale,
           cudaStream_t s) {
  auto run = [&](auto kern) {
    return kern(q, k, v, out, lse, b, sq, hkv, g, dh, qsb, qst, qsh, ksb,
                kst, ksh, q_offset, kv_len, causal, scale, s);
  };
  if (dh <= 64) return run(launch_dc<TQ, TKV, 4>);
  if (dh <= 80) return run(launch_dc<TQ, TKV, 5>);
  if (dh <= 128) return run(launch_dc<TQ, TKV, 8>);
  return run(launch_dc<TQ, TKV, 16>);
}

}  // namespace

// The tf32x3 variant (flash_prefill_tf32.cu).
int tardis_flash_prefill_tf32(const void* q, const void* k, const void* v,
                              void* out, float* lse, int b, int sq, int hkv,
                              int g, int dh, long long qsb, long long qst,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, int q_offset, int kv_len,
                              int causal, float scale, int kv_dtype,
                              cudaStream_t s);

// dtype codes: 0 = float32, 1 = bfloat16.  q (B, Sq, H, Dh) at strides
// (qsb, qst, qsh) and out (B, Sq, H, Dh) contiguous, both in q_dtype; lse
// null or fp32 (B, H, Sq) contiguous; k and v (B, Skv, Hkv, Dh) at the
// shared strides (ksb, kst, ksh) in kv_dtype: both float32, both
// bfloat16, or a float32 q over bfloat16 K/V.  Dh is contiguous
// everywhere.  kv_len <= Skv (the wrapper clamps it).  variant: 0 =
// simt, 1 = wgmma, 2 = tf32x3 (kernel.py: VARIANTS); cudaErrorInvalidValue
// where it does not take the call.
extern "C" int tardis_flash_prefill(
    const void* q, const void* k, const void* v, void* out, void* lse_p,
    int b, int sq, int hkv, int g, int dh, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, int q_offset,
    int kv_len, int causal, float scale, int variant, int q_dtype,
    int kv_dtype, void* stream) {
  if (b == 0 || sq == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  if (dh <= 0 || dh > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* lse = static_cast<float*>(lse_p);
  auto run = [&](auto launcher) {
    return launcher(q, k, v, out, lse, b, sq, hkv, g, dh, qsb, qst, qsh, ksb,
                    kst, ksh, q_offset, kv_len, causal, scale, s);
  };
  if (variant == 2) {
    if (q_dtype != 0) return (int)cudaErrorInvalidValue;
    return tardis_flash_prefill_tf32(q, k, v, out, lse, b, sq, hkv, g, dh,
                                     qsb, qst, qsh, ksb, kst, ksh, q_offset,
                                     kv_len, causal, scale, kv_dtype, s);
  }
  if (variant == 1) {
    if (q_dtype != 1 || kv_dtype != 1) return (int)cudaErrorInvalidValue;
    const int r = run(try_wgmma);
    return r >= 0 ? r : (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) return run(launch<float, float>);
  if (q_dtype == 0 && kv_dtype == 1)
    return run(launch<float, __nv_bfloat16>);
  if (q_dtype == 1 && kv_dtype == 1)
    return run(launch<__nv_bfloat16, __nv_bfloat16>);
  return (int)cudaErrorInvalidValue;
}
