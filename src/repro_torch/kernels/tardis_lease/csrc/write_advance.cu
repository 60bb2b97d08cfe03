// K2 write_advance: the Tardis writer jump-ahead (paper Table I store rule)
// over the blocks selected by a mask, in ONE launch.
//
// Replaces src/repro/kernels/tardis_lease/kernel.py: rowmax_table
// (_rowmax_kernel) and advance_table (_advance_kernel), as composed by
// ops.write_advance.  The TPU version reduced row maxima in one kernel,
// finished the max and built ts in XLA, then ran the advance kernel with ts
// as a scalar prefetch.  Here one launch computes
//   ts = max(pts, max(masked rts, -1) + 1);  wts = rts = ts where masked
// and writes new_wts, new_rts and ts (none of them pre-filled).
//
// Design: each thread loads its entries' mask, rts and wts words once, up
// to kPer of them (entry base + k * stride, coalesced), and keeps them in
// registers through the reduction; it writes both outputs from those
// registers afterwards -- no second read, no second launch.  The maximum
// is reduced per warp (__reduce_max_sync), across the CTA's warps through
// shared memory, and, when the launch is a thread-block cluster of up to 8
// CTAs, pushed by each CTA into every CTA's shared memory (distributed
// shared memory, map_shared_rank) before one cluster barrier; each CTA
// then folds the cluster's maxima itself.  Integer max is
// order-independent, so the result is bit-identical however the CTAs are
// scheduled.  Entries past kPer * (CTAs x threads) -- tables beyond ~6.5
// x 10^4 blocks on a cluster of 8 -- are read twice (once for the max,
// once for the write), still in the one launch.  The caller picks the
// CTAs (n_ctas; one CTA skips the cluster barrier): the wrapper gives
// each thread one entry up to a cluster of 8, so the serving table (4608
// blocks) runs on 5 CTAs -- as fast as one CTA holding 5 entries a
// thread, and larger tables load in parallel (scripts/k2_variants.py).
//
// Bound on the H100: bytes (three int32 reads and two int32 writes per
// entry; ~90 KB at the serving table size), so in practice the launch.
#include "tardis_hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;            // entries a thread holds in registers

__global__ void __launch_bounds__(kThreads)
    write_advance_kernel(const int* __restrict__ wts,
                         const int* __restrict__ rts,
                         const int* __restrict__ mask, int n, int pts,
                         int* __restrict__ new_wts,
                         int* __restrict__ new_rts, int* __restrict__ ts) {
  __shared__ int part[kWarps];
  __shared__ int tops[kTardisMaxSplit];
  tardis_cg::cluster_group cluster = tardis_cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cta = static_cast<int>(cluster.block_rank());
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int stride = ctas * kThreads;
  const int base = cta * kThreads + tid;
  int w[kPer], r[kPer];
  unsigned held = 0;                 // bit k: entry k is masked
  int top = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k * stride;
    if (i < n) {
      const int m = mask[i];
      r[k] = rts[i];
      w[k] = wts[i];
      if (m != 0) {
        held |= 1u << k;
        top = max(top, r[k]);
      }
    }
  }
  for (int i = base + kPer * stride; i < n; i += stride)
    if (mask[i] != 0) top = max(top, rts[i]);
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) part[warp] = top;
  __syncthreads();
  if (warp == 0) {
    const int t = __reduce_max_sync(kFull, lane < kWarps ? part[lane] : -1);
    if (ctas == 1) {
      if (lane == 0) tops[0] = t;
    } else if (lane < ctas) {
      cluster.map_shared_rank(tops, lane)[cta] = t;
    }
  }
  if (ctas == 1)
    __syncthreads();
  else
    cluster.sync();                  // every CTA's maximum in every CTA
  int t = tops[0];
  for (int c = 1; c < ctas; ++c) t = max(t, tops[c]);
  const int stamp = max(pts, t + 1);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k * stride;
    if (i < n) {
      const bool m = (held >> k) & 1u;
      new_wts[i] = m ? stamp : w[k];
      new_rts[i] = m ? stamp : r[k];
    }
  }
  for (int i = base + kPer * stride; i < n; i += stride) {
    const bool m = mask[i] != 0;
    new_wts[i] = m ? stamp : wts[i];
    new_rts[i] = m ? stamp : rts[i];
  }
  if (cta == 0 && tid == 0) *ts = stamp;
}

}  // namespace

// wts/rts/mask (n,) int32, pts the writer's timestamp; outputs new_wts,
// new_rts (n,) and ts (), none of them pre-filled.  n_ctas: the CTAs of
// the launch, 1 to 8 (more than one: one thread-block cluster).
extern "C" int tardis_write_advance(const void* wts, const void* rts,
                                    const void* mask, int pts, int n,
                                    int n_ctas, void* new_wts, void* new_rts,
                                    void* ts, void* stream) {
  if (n < 0 || n_ctas < 1 || n_ctas > kTardisMaxSplit)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(write_advance_kernel, 1, n_ctas, kWarps, 0,
                        (cudaStream_t)stream, (const int*)wts,
                        (const int*)rts, (const int*)mask, n, pts,
                        (int*)new_wts, (int*)new_rts, (int*)ts);
}
