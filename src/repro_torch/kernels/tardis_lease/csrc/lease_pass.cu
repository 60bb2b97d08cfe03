// K1 lease_pass: the Tardis wave lease pass (paper Tables II-III) for G >= 1
// requester groups in one launch.
//
// Replaces src/repro/kernels/tardis_lease/kernel.py: lease_table_many
// (_lease_many_kernel / _lease_many_pred_kernel, via _lease_many_step) and
// lease_table (_lease_kernel / _lease_pred_kernel, the G == 1 case).
//
// Per flat block entry i and group g with mask[g, i]:
//   new_rts[i]  = max over masked g of max(rts, wts + lease, pts_g + lease)
//   flags[g, i] = (req == wts) | (pts_g > rts) << 1   (pre-call snapshot)
// and two reductions that replace the TPU kernel's (R, 1) row maxima:
//   write_ts    = max(max(rts over the union mask), -1) + 1
//   new_pts[g]  = max(pts_g, 0, max(wts over mask & pts_g <= rts))
//
// Design: ONE launch of one thread-block cluster of up to 8 CTAs (the
// portable size) and nothing else -- the outputs are not pre-filled.  Each
// CTA loops over its share of the N entries (1024 threads, so the serving
// table of 4608 blocks takes one round on 5 CTAs) and writes new_rts and
// flags, the mask words of each batch of 4 groups requested together
// (the first batch with the entry's own words).  The G + 1 maxima (the
// consumed wts of each group, then max(rts) + 1 over the union mask; 0 is
// the identity of both) are reduced per warp by __reduce_max_sync and
// kept in registers (lane l keeps groups
// l and l + 32), then across the CTA's warps through shared memory (a
// warp per maximum), and each CTA pushes its maxima into CTA 0's shared
// memory through distributed shared memory (map_shared_rank); after one
// cluster barrier (release / acquire) CTA 0 folds them from its own
// shared memory and writes write_ts and new_pts.  No atomics, no global
// scratch, no remote loads; integer max is order-independent, so the
// result is bit-identical however the CTAs are scheduled.  G is held up
// to kMaxGroups (the serving waves take G <= replicas).
//
// Bound on the H100: bytes.  Each entry reads wts/rts/req (+ lease) and G
// mask words and writes new_rts and G flag words -- a few bytes of int32
// per entry, no arithmetic to speak of.  At the serving table size the
// whole pass is ~100 KB, far below what a launch costs: the design is one
// launch with coalesced int32 accesses; the lease is a scalar argument
// (static policy) or a per-block pointer (predictor).
#include "tardis_hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 64;          // two a lane
constexpr int kSlots = kMaxGroups + 1;
constexpr int kGroupBatch = 4;          // groups whose masks load together

__global__ void __launch_bounds__(kThreads)
    lease_pass_kernel(const int* __restrict__ wts, const int* __restrict__ rts,
                      const int* __restrict__ req,
                      const int* __restrict__ masks,
                      const int* __restrict__ pts,
                      const int* __restrict__ lease_vec, int lease, int n,
                      int g, int* __restrict__ new_rts,
                      int* __restrict__ flags, int* __restrict__ write_ts,
                      int* __restrict__ new_pts) {
  // per warp (CTA 0: per CTA): the G consumed maxima, then the top
  __shared__ int part[kWarps][kSlots];
  __shared__ int gather[kTardisMaxSplit][kSlots];
  tardis_cg::cluster_group cluster = tardis_cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cta = static_cast<int>(cluster.block_rank());
  const int ctas = static_cast<int>(cluster.num_blocks());
  int acc0 = 0, acc1 = 0, top = 0;   // this lane's groups; the top
  for (int base = cta * kThreads; base < n; base += ctas * kThreads) {
    const int i = base + tid;
    const bool in = i < n;
    // a batch's mask words and timestamps, requested together (the first
    // batch with the entry's own words)
    int mk[kGroupBatch], pk[kGroupBatch];
    auto load_batch = [&](int g0) {
#pragma unroll
      for (int k = 0; k < kGroupBatch; ++k) {
        const bool live = g0 + k < g;
        mk[k] = live && in ? masks[static_cast<size_t>(g0 + k) * n + i] : 0;
        pk[k] = live ? __ldg(pts + g0 + k) : 0;
      }
    };
    load_batch(0);
    int w = 0, r = 0, rq = 0, L = lease;
    if (in) {
      w = wts[i];
      r = rts[i];
      rq = req[i];
      if (lease_vec != nullptr) L = lease_vec[i];
    }
    int nr = r;
    bool any = false;
    for (int g0 = 0; g0 < g; g0 += kGroupBatch) {
      if (g0 > 0) load_batch(g0);
#pragma unroll
      for (int k = 0; k < kGroupBatch; ++k) {
        const int gi = g0 + k;
        if (gi >= g) break;
        const int p = pk[k];
        const size_t at = static_cast<size_t>(gi) * n + i;
        int consumed = 0;
        if (mk[k] != 0) {
          nr = max(nr, max(max(r, w + L), p + L));
          any = true;
          flags[at] = (rq == w ? 1 : 0) | (p > r ? 2 : 0);
          if (p <= r) consumed = w;
        } else if (in) {
          flags[at] = 0;
        }
        consumed = __reduce_max_sync(kFull, consumed);
        if (lane == (gi & 31)) {
          if (gi < 32)
            acc0 = max(acc0, consumed);
          else
            acc1 = max(acc1, consumed);
        }
      }
    }
    if (in) new_rts[i] = nr;
    top = max(top, __reduce_max_sync(kFull, any ? r + 1 : 0));
  }
  if (lane < g) part[warp][lane] = acc0;
  if (lane + 32 < g) part[warp][lane + 32] = acc1;
  if (lane == 0) part[warp][g] = top;
  __syncthreads();
  int* dst = cluster.map_shared_rank(&gather[0][0], 0) + cta * kSlots;
  for (int j = warp; j <= g; j += kWarps) {
    const int m = __reduce_max_sync(kFull, lane < kWarps ? part[lane][j] : 0);
    if (lane == 0) dst[j] = m;
  }
  cluster.sync();          // every CTA's maxima in CTA 0's gather
  if (cta == 0) {
    for (int j = tid; j <= g; j += kThreads) {
      int m = 0;
      for (int c = 0; c < ctas; ++c) m = max(m, gather[c][j]);
      if (j < g)
        new_pts[j] = max(max(pts[j], 0), m);
      else
        *write_ts = m;
    }
  }
}

}  // namespace

// wts/rts/req (n,) int32, masks (g, n), pts (g,), lease_vec (n,) or NULL
// (then the scalar lease); outputs new_rts (n,), flags (g, n), write_ts (),
// new_pts (g,), none of them pre-filled.  g <= 64.
extern "C" int tardis_lease_pass(const void* wts, const void* rts,
                                 const void* req, const void* masks,
                                 const void* pts, const void* lease_vec,
                                 int lease, int n, int g, void* new_rts,
                                 void* flags, void* write_ts, void* new_pts,
                                 void* stream) {
  if (n < 0 || g < 0 || g > kMaxGroups) return (int)cudaErrorInvalidValue;
  const int rounds = (n + kThreads - 1) / kThreads;
  const int ctas = rounds < 1 ? 1 : rounds > kTardisMaxSplit ? kTardisMaxSplit
                                                              : rounds;
  return launch_cluster(lease_pass_kernel, 1, ctas, kWarps, 0,
                        (cudaStream_t)stream, (const int*)wts,
                        (const int*)rts, (const int*)req, (const int*)masks,
                        (const int*)pts, (const int*)lease_vec, lease, n, g,
                        (int*)new_rts, (int*)flags, (int*)write_ts,
                        (int*)new_pts);
}
