// K5 dense_decode: GQA flash-decode of one query token per request over a
// dense (B, T, Hkv, Dh) KV cache, split over KV positions.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
// decode_attention_grouped (_decode_kernel).  Semantics kept: for each
// (b, kv head h) the G query heads of that group attend over cache
// positions t < kv_len with scores q.k_t * scale; the softmax runs in fp32
// as (m, l, acc) with p = 0 wherever m <= NEG_INF; the output is
// acc / max(l, 1e-30) in q's dtype.  kv_len is ONE int32 on the device,
// read through a pointer (no host sync per layer; the call can be
// captured in a CUDA graph), clamped into [0, T].
//
// Layout: the cache is read where it lies -- one layer's (B, T, Hkv, Dh)
// view of the stacked cache, with its batch / token / head strides in
// elements and Dh contiguous -- instead of the TPU wrapper's transpose to
// (B*Hkv, T, Dh), which would copy the whole cache on every call.  Dh is
// not padded to 128 (that padding was for the TPU's lanes): any Dh <= 256
// (64 for tinyllama, 80 for zamba2).
//
// Grid: (B*Hkv, ceil(T / split)).  A wave gives only B*Hkv = 16 (b, head)
// pairs at tinyllama's shapes for 132 SMs, so each CTA takes `split`
// consecutive positions of one pair and returns at once when they all lie
// at or past kv_len.  It streams its positions in tiles: each thread loads
// its share of the tile's K and V rows as 16-byte vectors into registers
// (all loads in flight together), then stores them to shared memory as
// fp32 -- lanes walk positions and rows sit dh + 1 floats apart, so both
// the stores and the score loop's reads (32 positions at one d) hit 32
// banks.  The next tile's loads are issued before the current tile is
// computed, so they overlap the math.  The CTA's threads compute the
// G x tile scores, one warp per query head runs the softmax update with
// shuffles, and the P.V product accumulates in shared memory.  Each CTA
// writes its unnormalised (m, l, acc) partial to fp32 scratch; a second
// kernel, one CTA per pair, folds the partials of the splits below kv_len
// and writes the output.  Dh and the strides must be multiples of one
// vector (8 bf16 or 4 fp32 elements), the cache base 16-byte aligned.
//
// Bound on the H100: bytes.  Each live K/V element is read once and used
// in 2 * G multiply-adds: at G <= 8 that is ~4 flop/B in bf16, far below
// the ~295 flop/B where the tensor cores would bind, so tensor cores and
// TMA are not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 64;     // positions per tile, at most
constexpr int kThreads = 128;
constexpr int kUnroll = 8;       // 16-byte K (and V) vectors per thread
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int clamp_len(const int* kv_len_ptr, int t) {
  return max(0, min(*kv_len_ptr, t));
}

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

// Positions per tile: one round of kUnroll vectors per thread covers it.
template <typename T> int tile_for(int dh) {
  const int t = kThreads * kUnroll * Vec<T>::n / dh;
  return t < kMaxTile ? t : kMaxTile;
}

// Issue the loads of K/V rows [t0, t0 + n_t) of the tile: vector idx
// covers position idx % tile, elements (idx / tile) * VEC onward.
template <typename T>
__device__ __forceinline__ void load_tile(
    uint4 (&kr)[kUnroll], uint4 (&vr)[kUnroll], const T* kb, const T* vb,
    int t0, int n_t, int tile, int n_vec, long long st, int tid) {
  constexpr int VEC = Vec<T>::n;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int idx = tid + u * kThreads;
    const int t = idx % tile, c = idx / tile;
    if (idx < n_vec && t < n_t) {
      const long long off = static_cast<long long>(t0 + t) * st + c * VEC;
      kr[u] = *reinterpret_cast<const uint4*>(kb + off);
      vr[u] = *reinterpret_cast<const uint4*>(vb + off);
    } else {
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Store the loaded vectors to shared memory as fp32 rows of `row` floats.
template <typename T>
__device__ __forceinline__ void store_tile(
    const uint4 (&kr)[kUnroll], const uint4 (&vr)[kUnroll], float* ks,
    float* vs, int tile, int n_vec, int row, int tid) {
  constexpr int VEC = Vec<T>::n;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int idx = tid + u * kThreads;
    if (idx < n_vec) {
      const int t = idx % tile, c = idx / tile;
      float kf[VEC], vf[VEC];
      Vec<T>::unpack(kr[u], kf);
      Vec<T>::unpack(vr[u], vf);
      float* kd = ks + t * row + c * VEC;
      float* vd = vs + t * row + c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kd[e] = kf[e];
        vd[e] = vf[e];
      }
    }
  }
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads) dense_decode_split(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v,
    const int* __restrict__ kv_len_ptr, int hkv, int g, int dh, int t_max,
    int split, int tile, long long sb, long long st, long long sh,
    float scale, float* __restrict__ part_acc, float* __restrict__ part_ml) {
  const int kv_len = clamp_len(kv_len_ptr, t_max);
  const int bh = blockIdx.x, sp = blockIdx.y;
  const int lo = sp * split;
  if (lo >= kv_len) return;               // nothing live in this split
  const int hi = min(lo + split, kv_len);

  extern __shared__ float smem[];
  const int row = dh + 1;                 // padded: no bank conflicts
  float* qs = smem;                       // g * dh
  float* ks = qs + g * dh;                // tile * row
  float* vs = ks + tile * row;            // tile * row
  float* sc = vs + tile * row;            // g * tile
  float* acc = sc + g * tile;             // g * dh
  float* m_s = acc + g * dh;              // g
  float* l_s = m_s + g;                   // g
  float* alpha = l_s + g;                 // g

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kThreads / 32;
  const int b = bh / hkv, h = bh - b * hkv;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  const int n_vec = tile * (dh / Vec<T>::n);
  uint4 kr[kUnroll], vr[kUnroll];
  load_tile<T>(kr, vr, kb, vb, lo, min(tile, hi - lo), tile, n_vec, st, tid);

  const TQ* qb = q + static_cast<long long>(bh) * g * dh;
  for (int x = tid; x < g * dh; x += kThreads) {
    qs[x] = to_f32(qb[x]);
    acc[x] = 0.f;
  }
  for (int x = tid; x < g; x += kThreads) {
    m_s[x] = kNegInf;
    l_s[x] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int n_t = min(tile, hi - t0);
    __syncthreads();   // the previous tile's readers are done
    store_tile<T>(kr, vr, ks, vs, tile, n_vec, row, tid);
    __syncthreads();
    if (t0 + tile < hi)                   // the next tile's loads fly now
      load_tile<T>(kr, vr, kb, vb, t0 + tile, min(tile, hi - t0 - tile),
                   tile, n_vec, st, tid);
    for (int x = tid; x < g * tile; x += kThreads) {
      const int gi = x / tile, t = x - gi * tile;
      float s = kNegInf;
      if (t < n_t) {
        const float* qr = qs + gi * dh;
        const float* kr_s = ks + t * row;
        s = 0.f;
        for (int d = 0; d < dh; ++d) s += qr[d] * kr_s[d];
        s *= scale;
      }
      sc[x] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += n_warps) {   // one warp per head
      float* sr = sc + gi * tile;
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = (m_new <= kNegInf || t >= n_t)
                            ? 0.f : expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * a + sum;
        m_s[gi] = m_new;
        alpha[gi] = a;
      }
    }
    __syncthreads();
    for (int x = tid; x < g * dh; x += kThreads) {
      const int gi = x / dh, d = x - gi * dh;
      const float* pr = sc + gi * tile;
      float a = acc[x] * alpha[gi];
      for (int t = 0; t < n_t; ++t) a += pr[t] * vs[t * row + d];
      acc[x] = a;
    }
  }
  __syncthreads();
  const long long part = static_cast<long long>(bh) * gridDim.y + sp;
  float* pa = part_acc + part * g * dh;
  for (int x = tid; x < g * dh; x += kThreads) pa[x] = acc[x];
  float* pm = part_ml + part * 2 * g;
  for (int x = tid; x < g; x += kThreads) {
    pm[x] = m_s[x];
    pm[g + x] = l_s[x];
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads) dense_decode_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ kv_len_ptr, int g, int dh, int t_max, int split,
    int n_split, TQ* __restrict__ out) {
  const int kv_len = clamp_len(kv_len_ptr, t_max);
  const int n_live = min(n_split, (kv_len + split - 1) / split);
  const int bh = blockIdx.x;
  const float* pa = part_acc + static_cast<long long>(bh) * n_split * g * dh;
  const float* pm = part_ml + static_cast<long long>(bh) * n_split * 2 * g;
  TQ* ob = out + static_cast<long long>(bh) * g * dh;
  for (int x = threadIdx.x; x < g * dh; x += kThreads) {
    const int gi = x / dh;
    float m = kNegInf;
    for (int s = 0; s < n_live; ++s) m = fmaxf(m, pm[s * 2 * g + gi]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float w = expf(pm[s * 2 * g + gi] - m);
      l += pm[s * 2 * g + g + gi] * w;
      a += pa[static_cast<long long>(s) * g * dh + x] * w;
    }
    ob[x] = from_f32<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int b, int hkv, int g, int dh, int t_max, int split, long long sb,
           long long st, long long sh, float scale, void* part_acc,
           void* part_ml, void* out, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::n;
  if (dh % VEC || sb % VEC || st % VEC || sh % VEC ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int tile = tile_for<T>(dh);
  const size_t smem = sizeof(float) * (2 * g * dh + 2 * tile * (dh + 1) +
                                       g * tile + 3 * g);
  auto kern = dense_decode_split<TQ, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_split = (t_max + split - 1) / split;
  kern<<<dim3(b * hkv, n_split), kThreads, smem, stream>>>(
      (const TQ*)q, (const T*)k, (const T*)v, (const int*)kv_len, hkv, g, dh,
      t_max, split, tile, sb, st, sh, scale, (float*)part_acc,
      (float*)part_ml);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dense_decode_combine<TQ><<<b * hkv, kThreads, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, (const int*)kv_len, g,
      dh, t_max, split, n_split, (TQ*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q and out share q_dtype;
// k and v share kv_dtype: both float32, both bfloat16, or a float32 q
// over bfloat16 caches (the wave path with fp32 weights keeps bf16
// caches, as the JAX package does; the TPU kernel cast both to fp32).
// part_acc: B*Hkv*n_split*G*Dh floats; part_ml: B*Hkv*n_split*2*G floats,
// n_split = ceil(t_max / split).  Dh and the cache strides are multiples
// of 16 bytes' worth of elements, the caches 16-byte aligned.
extern "C" int tardis_dense_decode(const void* q, const void* k,
                                   const void* v, const void* kv_len, int b,
                                   int hkv, int g, int dh, int t_max,
                                   int split, long long sb, long long st,
                                   long long sh, float scale, int q_dtype,
                                   int kv_dtype, void* part_acc,
                                   void* part_ml, void* out, void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  if (t_max <= 0 || split <= 0 || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, kv_len, b, hkv, g, dh, t_max, split,
                                sb, st, sh, scale, part_acc, part_ml, out, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, kv_len, b, hkv, g, dh,
                                        t_max, split, sb, st, sh, scale,
                                        part_acc, part_ml, out, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kv_len, b, hkv, g, dh, t_max, split, sb, st, sh, scale,
        part_acc, part_ml, out, s);
  return (int)cudaErrorInvalidValue;
}
