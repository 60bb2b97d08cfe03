// K5 dense_decode: GQA flash-decode of one query token per request over a
// dense (B, T, Hkv, Dh) KV cache, split over KV positions.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
// decode_attention_grouped (_decode_kernel).  Semantics kept: for each
// (b, kv head h) the G query heads of that group attend over cache
// positions t < kv_len with scores q.k_t * scale; the softmax runs in fp32
// as (m, l, acc) with p = 0 wherever no position is live; the output is
// acc / max(l, 1e-30) in q's dtype (0 at kv_len = 0).  kv_len is ONE int32
// on the device, read through a pointer (no host sync per layer; the call
// can be captured in a CUDA graph), clamped into [0, T].
//
// Layout: the cache is read where it lies -- one layer's (B, T, Hkv, Dh)
// view of the stacked cache, with its batch / token / head strides in
// elements and Dh contiguous -- instead of the TPU wrapper's transpose to
// (B*Hkv, T, Dh), which would copy the whole cache on every call.  Dh is
// not padded to 128 (that padding was for the TPU's lanes): any Dh <= 256
// (64 for tinyllama, 80 for zamba2) in whole 16-byte vectors.
//
// Bound on the H100: bytes.  Each live K/V element is read once and used
// in 2 * G multiply-adds: at G <= 8 that is ~4 flop/B in bf16, far below
// the ~295 flop/B where the tensor cores would bind; what costs is the
// instructions and latency around each position.  The first design lost
// to latency, not bytes: a (B*Hkv, T / 256) grid gave ~6 warps
// an SM at tinyllama's shape, three CTA barriers a 64-position tile, K and
// V widened to fp32 in shared memory with every score a 64-long chain of
// shared loads, and a second combine launch.
//
// This design:
// * Parallelism sized to the card.  Grid (B*Hkv*ceil(G/8), n_split) in
//   clusters of (1, n_split): the CTAs of one (b, kv head) pair form one
//   thread-block cluster.  The wrapper picks n_split (at most 8, the
//   portable cluster size) from the pairs and T so that the grid fills
//   the SMs (kernel.dense_split).  The positions [0, kv_len) are spread
//   over the splits ON THE DEVICE: each CTA takes ceil(kv_len / n_split)
//   of them, so every kv_len keeps every split busy and a graph replayed
//   at another kv_len stays balanced.
// * Warp-local work, no CTA barrier in the loop: each warp streams its
//   own runs of positions through a warp-private cp.async ring in shared
//   memory, K and V in their stored dtype, several stages in flight.
// * The bf16 pair (Dh a multiple of 16 up to 128) runs on the tensor
//   cores, 8 warps a CTA: mma.sync m16n8k16 with the G query heads of the
//   KV head as the rows (padded to 16) and 16 positions a stage, K/V rows
//   swizzled by 16-byte chunk so ldmatrix reads them without bank
//   conflicts.  Q.K^T is exact (bf16 products, fp32 sums); P enters P.V
//   exactly, as three bf16 parts whose sum is the fp32 P, so K5 keeps the
//   fp32-P numbers of its plain version.  The fp32 pairs (and bf16 at any
//   other Dh) run the SIMT variant: lanes split Dh into 16-byte vectors
//   (a group of GS lanes per position), scores are register dot products
//   reduced with shuffles, and each lane reads back only the vectors it
//   copied itself, so cp.async.wait_group alone orders its ring.  Both
//   keep fp32 (m, l, acc), 2^x with scale * log2(e) folded in once.
// * One merge at the end, in the same launch (finish_cluster): across
//   the warps through shared memory, then across the cluster's CTAs
//   through distributed shared memory, behind one cluster barrier.  No
//   global scratch, no atomics, no second kernel; a graph replay needs
//   nothing reset.  (A first version combined through global partials
//   and an atomic ticket taken by the last CTA: its tail of dependent L2
//   round trips cost more.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tardis_hopper.cuh"

namespace {

constexpr int kWarps = 4;       // a CTA of the SIMT variant
constexpr int kThreads = 32 * kWarps;
constexpr int kMmaWarps = 8;    // a CTA of the tensor-core variant
constexpr int kStages = 4;       // cp.async ring depth, per lane
constexpr int kUnroll = 2;       // position rows per lane per stage
constexpr int kHeadChunk = 8;    // query heads per CTA, at most

// A 16-byte vector of K or V as fp32: 4 floats or 8 bf16 (the element at
// the lower address sits in the low half of each 32-bit word).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The (m, l, acc) of this lane merged with the lane `o` apart (same Dh
// slice, other positions).
template <int NG, int NE>
__device__ __forceinline__ void merge_lanes(float (&m)[NG], float (&l)[NG],
                                            float (&acc)[NG][NE], int o) {
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
    const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
    const float mn = fmaxf(m[gi], mo);
    const float a = exp2f(m[gi] - mn), b = exp2f(mo - mn);
    l[gi] = l[gi] * a + lo * b;
    m[gi] = mn;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
      acc[gi][e] = acc[gi][e] * a + ao * b;
    }
  }
}

// NG: query heads held per lane (>= the CTA's heads); GS: lanes per
// position (a power of 2 >= Dh / VEC, at most 32); NV: 16-byte vectors
// per lane per row (Dh / VEC > 32 only for fp32 rows of Dh > 128).
template <typename TQ, typename T, int NG, int GS, int NV>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len_ptr, int hkv,
    int g, int dh, int t_max, int n_hc, long long sb, long long st,
    long long sh, float scale2, TQ* __restrict__ out) {
  constexpr int VEC = Vec<T>::n;
  constexpr int NE = NV * VEC;            // Dh elements per lane
  constexpr int R = 32 / GS;              // positions per warp load
  constexpr int ROWS = R * kUnroll;       // positions per warp stage
  constexpr int SLOT = kUnroll * NV * 2;  // 16-byte vectors per lane-stage
  constexpr int STAGE = kWarps * SLOT * 32;
  extern __shared__ uint4 ring[];         // [kStages][kWarps][SLOT][32]
  const int kv_len = max(0, min(*kv_len_ptr, t_max));
  const int n_split = gridDim.y, sp = blockIdx.y, pid = blockIdx.x;
  const int hc = pid % n_hc, bh = pid / n_hc;
  const int b = bh / hkv, h = bh - b * hkv;
  const int g0 = hc * kHeadChunk, ng = min(g - g0, kHeadChunk);
  TQ* ob = out + (static_cast<long long>(bh) * g + g0) * dh;
  const int tid = threadIdx.x;
  // the live positions, spread over the splits on the device (a split
  // past kv_len takes none but still joins the cluster's merge)
  const int per = (kv_len + n_split - 1) / n_split;
  const int lo = min(sp * per, kv_len), hi = min(lo + per, kv_len);

  const int lane = tid & 31, warp = tid >> 5;
  const int r = lane / GS, c = lane % GS;
  const int n_chunks = dh / VEC;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  uint4* mine = ring + warp * SLOT * 32 + lane;
  const int n_it = (hi - lo + kWarps * ROWS - 1) / (kWarps * ROWS);

  auto issue = [&](int it) {              // this warp's stage `it`
    if (it < n_it) {
      const int base = lo + (it * kWarps + warp) * ROWS;
      uint4* dst = mine + (it % kStages) * STAGE;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + u * R + r;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int ch = c + j * GS;
          const bool ok = t < hi && ch < n_chunks;
          const long long off = ok ? t * st + ch * VEC : 0;
          cp_async16(dst + ((u * NV + j) * 2) * 32, kb + off, ok);
          cp_async16(dst + ((u * NV + j) * 2 + 1) * 32, vb + off, ok);
        }
      }
    }
    cp_async_commit();                    // an empty group past the end
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);

  // q's slice for this lane, pre-scaled by scale * log2(e)
  float qr[NG][NE];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int ch = c + j * GS;
      const bool ok = gi < ng && ch < n_chunks;
      const TQ* qp = q + (static_cast<long long>(bh) * g + g0 + gi) * dh +
                     ch * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[gi][j * VEC + e] = ok ? to_f32(qp[e]) * scale2 : 0.f;
    }

  float m[NG], l[NG], acc[NG][NE];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    m[gi] = kTardisNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[gi][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 1>();         // stage `it` has landed
    const uint4* src = mine + (it % kStages) * STAGE;
    float kf[kUnroll][NE], vf[kUnroll][NE];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Vec<T>::unpack(src[((u * NV + j) * 2) * 32], &kf[u][j * VEC]);
        Vec<T>::unpack(src[((u * NV + j) * 2 + 1) * 32], &vf[u][j * VEC]);
      }
    const int base = lo + (it * kWarps + warp) * ROWS;
    float s[kUnroll][NG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) x = fmaf(qr[gi][e], kf[u][e], x);
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        s[u][gi] = x;
      }
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) live[u] = base + u * R + r < hi;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) mx = fmaxf(mx, s[u][gi]);
      const float alpha = exp2f(m[gi] - mx);
      float p[kUnroll], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = live[u] ? exp2f(s[u][gi] - mx) : 0.f;
        sum += p[u];
      }
      l[gi] = l[gi] * alpha + sum;
      m[gi] = mx;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        float a = acc[gi][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[gi][e] = a;
      }
    }
    issue(it + kStages);                  // into the slot just read
  }
  cp_async_wait<0>();

  // merge the warp's row groups (lanes GS, 2 GS, ... apart)
#pragma unroll
  for (int o = GS; o < 32; o <<= 1) merge_lanes<NG, NE>(m, l, acc, o);

  // merge the CTA's warps through shared memory (the ring is done)
  __syncthreads();
  float* wml = reinterpret_cast<float*>(ring);    // [kWarps][2][NG]
  float* wacc = wml + kWarps * 2 * NG;  // [kWarps][NG][acc_stride(dh)]
  if (r == 0) {
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (c == 0) {
        wml[(warp * 2) * NG + gi] = m[gi];
        wml[(warp * 2 + 1) * NG + gi] = l[gi];
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int ch = c + j * GS;
        if (ch < n_chunks)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            wacc[(warp * NG + gi) * acc_stride(dh) + ch * VEC + e] =
                acc[gi][j * VEC + e];
      }
    }
  }
  __syncthreads();
  finish_cluster<TQ, NG, kWarps>(
      wml, wacc,
      reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                               part_offset(sizeof(uint4) * kStages * STAGE,
                                           kWarps, NG, dh)),
      ng, dh, ob);
}

// ---- the tensor-core variant for the bf16 pair -----------------------------

// The bf16 pair with Dh a multiple of 16: each warp stages 16
// positions of K and V at a time (cp.async into rows swizzled by 16-byte
// chunk, a warp-private ring), Q.K^T and P.V on mma.sync m16n8k16 with the
// G query heads as the rows (padded to 16).  P enters P.V exactly, as the
// three bf16 parts whose sum is the fp32 P (8 + 8 + 8 significant bits):
// the products are those of the fp32 P, accumulated in fp32.
template <int DH>
__global__ void __launch_bounds__(kMmaWarps * 32) dense_decode_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len_ptr,
    int hkv, int g, int t_max, int n_hc, long long sb, long long st,
    long long sh, float scale2, __nv_bfloat16* __restrict__ out) {
  using Tile = DecodeRing<DH, kMmaWarps>;
  constexpr int KS = DH / 16, ND = DH / 8, CH = DH / 8;
  constexpr int NST = Tile::kStages, PITCH = Tile::kPitch;
  extern __shared__ uint4 ring[];         // [kMmaWarps][NST][K, V tiles]
  const int n_split = gridDim.y, sp = blockIdx.y, pid = blockIdx.x;
  const int hc = pid % n_hc, bh = pid / n_hc;
  const int b = bh / hkv, h = bh - b * hkv;
  const int g0 = hc * kHeadChunk, ng = min(g - g0, kHeadChunk);
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  // q as A fragments (row grp is head g0 + grp, rows 8-15 are zero),
  // loaded before kv_len so that the two loads overlap
  unsigned qa[KS][2];
  const __nv_bfloat16* qrow =
      q + (static_cast<long long>(bh) * g + g0 + min(grp, ng - 1)) * DH;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = grp < ng ? pack_pair(qrow + ks * 16 + 2 * tig) : 0u;
    qa[ks][1] = grp < ng ? pack_pair(qrow + ks * 16 + 8 + 2 * tig) : 0u;
  }
  const int kv_len = max(0, min(*kv_len_ptr, t_max));
  __nv_bfloat16* ob = out + (static_cast<long long>(bh) * g + g0) * DH;
  const int tid = threadIdx.x;
  const int per = (kv_len + n_split - 1) / n_split;
  const int lo = min(sp * per, kv_len), hi = min(lo + per, kv_len);

  const int warp = tid >> 5;
  const __nv_bfloat16* kb = k + b * sb + h * sh;
  const __nv_bfloat16* vb = v + b * sb + h * sh;
  unsigned char* wring =
      reinterpret_cast<unsigned char*>(ring) + warp * NST * 2 * Tile::kTile;
  constexpr int kRound = kMmaWarps * kDecodeStagePos;  // a round's positions
  const int n_it = (hi - lo + kRound - 1) / kRound;

  auto issue = [&](int it) {              // this warp's stage `it`
    if (it < n_it) {
      const int base = lo + (it * kMmaWarps + warp) * kDecodeStagePos;
      unsigned char* dst = wring + (it % NST) * 2 * Tile::kTile;
#pragma unroll
      for (int x = lane; x < kDecodeStagePos * CH; x += 32) {
        const int r = x / CH, c = x - r * CH;
        const bool ok = base + r < hi;
        const long long off = ok ? (base + r) * st + c * 8 : 0;
        cp_async16(dst + swz(r, c, PITCH), kb + off, ok);
        cp_async16(dst + Tile::kTile + swz(r, c, PITCH), vb + off, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NST; ++s) issue(s);

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m = kTardisNegInf, l = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<NST - 1>();
    __syncwarp();                         // every lane's copies landed
    const unsigned char* kt = wring + (it % NST) * 2 * Tile::kTile;
    decode_stage<DH>(kt, kt + Tile::kTile, qa,
                     lo + (it * kMmaWarps + warp) * kDecodeStagePos, hi,
                     scale2, m, l, acc);
    __syncwarp();                         // the slot is read: refill it
    issue(it + NST);
  }
  cp_async_wait<0>();

  __syncthreads();
  float* wml = reinterpret_cast<float*>(ring);     // [kMmaWarps][2][8]
  float* wacc = wml + kMmaWarps * 2 * kHeadChunk;  // [8 warps][8][stride]
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

template <typename TQ, typename T, int NG, int GS, int NV>
int launch_k(const void* q, const void* k, const void* v, const void* kv_len,
             int b, int hkv, int g, int dh, int t_max, int n_split,
             long long sb, long long st, long long sh, float scale, void* out,
             cudaStream_t stream) {
  constexpr int SLOT = kUnroll * NV * 2;
  const size_t ring = sizeof(uint4) * kStages * kWarps * SLOT * 32;
  const int n_hc = (g + kHeadChunk - 1) / kHeadChunk;
  return launch_cluster(dense_decode_kernel<TQ, T, NG, GS, NV>,
                        b * hkv * n_hc, n_split, kWarps,
                        smem_bytes(ring, kWarps, NG, dh, n_split), stream,
                        (const TQ*)q, (const T*)k, (const T*)v,
                        (const int*)kv_len, hkv, g, dh, t_max, n_hc, sb, st,
                        sh, scale * kTardisLog2e, (TQ*)out);
}

template <typename TQ, typename T, int NG>
int launch_gs(const void* q, const void* k, const void* v, const void* kv_len,
              int b, int hkv, int g, int dh, int t_max, int n_split,
              long long sb, long long st, long long sh, float scale,
              void* out, cudaStream_t s) {
  const int n_chunks = dh / Vec<T>::n;
#define TARDIS_K5(GS, NV)                                                   \
  return launch_k<TQ, T, NG, GS, NV>(q, k, v, kv_len, b, hkv, g, dh, t_max, \
                                     n_split, sb, st, sh, scale, out, s)
  if (n_chunks <= 4) TARDIS_K5(4, 1);
  if (n_chunks <= 8) TARDIS_K5(8, 1);
  if (n_chunks <= 16) TARDIS_K5(16, 1);
  if (n_chunks <= 32) TARDIS_K5(32, 1);
  if constexpr (Vec<T>::n == 4) {         // fp32 rows of Dh > 128
    if (n_chunks <= 64) TARDIS_K5(32, 2);
  }
#undef TARDIS_K5
  return (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v,
               const void* kv_len, int b, int hkv, int g, int t_max,
               int n_split, long long sb, long long st, long long sh,
               float scale, void* out, cudaStream_t stream) {
  const int n_hc = (g + kHeadChunk - 1) / kHeadChunk;
  return launch_cluster(dense_decode_mma<DH>, b * hkv * n_hc, n_split,
                        kMmaWarps,
                        smem_bytes(DecodeRing<DH, kMmaWarps>::kBytes,
                                   kMmaWarps, kHeadChunk, DH, n_split),
                        stream,
                        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                        (const __nv_bfloat16*)v, (const int*)kv_len, hkv, g,
                        t_max, n_hc, sb, st, sh, scale * kTardisLog2e,
                        (__nv_bfloat16*)out);
}

// The bf16 pair at Dh a multiple of 16 on the tensor cores;
// -1 for a Dh it has no instance of.
int try_mma(const void* q, const void* k, const void* v, const void* kv_len,
            int b, int hkv, int g, int dh, int t_max, int n_split,
            long long sb, long long st, long long sh, float scale, void* out,
            cudaStream_t s) {
#define TARDIS_K5_MMA(D)                                                   \
  case D:                                                                  \
    return launch_mma<D>(q, k, v, kv_len, b, hkv, g, t_max, n_split, sb,   \
                         st, sh, scale, out, s);
  switch (dh) {
    TARDIS_K5_MMA(16) TARDIS_K5_MMA(32) TARDIS_K5_MMA(48) TARDIS_K5_MMA(64)
    TARDIS_K5_MMA(80) TARDIS_K5_MMA(96) TARDIS_K5_MMA(112)
    TARDIS_K5_MMA(128)
  }
#undef TARDIS_K5_MMA
  return -1;
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int b, int hkv, int g, int dh, int t_max, int n_split,
           long long sb, long long st, long long sh, float scale,
           int tensor_cores, void* out, cudaStream_t s) {
  constexpr int VEC = Vec<T>::n;
  if (dh % VEC || sb % VEC || st % VEC || sh % VEC ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (tensor_cores) {
    if constexpr (sizeof(TQ) == 2 && sizeof(T) == 2) {
      const int r = try_mma(q, k, v, kv_len, b, hkv, g, dh, t_max, n_split,
                            sb, st, sh, scale, out, s);
      if (r >= 0) return r;
    }
    return (int)cudaErrorInvalidValue;
  }
  if (g == 1)
    return launch_gs<TQ, T, 1>(q, k, v, kv_len, b, hkv, g, dh, t_max,
                               n_split, sb, st, sh, scale, out, s);
  return launch_gs<TQ, T, kHeadChunk>(q, k, v, kv_len, b, hkv, g, dh, t_max,
                                      n_split, sb, st, sh, scale, out, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q and out share q_dtype;
// k and v share kv_dtype: both float32, both bfloat16, or a float32 q
// over bfloat16 caches (the wave path with fp32 weights keeps bf16
// caches, as the JAX package does; the TPU kernel cast both to fp32).
// tensor_cores picks the mma.sync variant (the bf16 pair at Dh a multiple
// of 16 up to 128; the caller decides, as it also sizes n_split for it),
// else the SIMT variant.  n_split (1 to 8) is the cluster size: the CTAs
// of one (b, kv head, 8-head chunk) pair.  Dh and the cache strides are
// multiples of 16 bytes' worth of elements, the caches 16-byte aligned.
extern "C" int tardis_dense_decode(const void* q, const void* k,
                                   const void* v, const void* kv_len, int b,
                                   int hkv, int g, int dh, int t_max,
                                   int n_split, long long sb, long long st,
                                   long long sh, float scale, int q_dtype,
                                   int kv_dtype, int tensor_cores, void* out,
                                   void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  if (t_max <= 0 || n_split <= 0 || n_split > kTardisMaxSplit || dh <= 0 ||
      dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, kv_len, b, hkv, g, dh, t_max,
                                n_split, sb, st, sh, scale, tensor_cores, out,
                                s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, kv_len, b, hkv, g, dh,
                                        t_max, n_split, sb, st, sh, scale,
                                        tensor_cores, out, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kv_len, b, hkv, g, dh, t_max, n_split, sb, st, sh, scale,
        tensor_cores, out, s);
  return (int)cudaErrorInvalidValue;
}
