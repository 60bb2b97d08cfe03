// K1 lease_pass: the Tardis wave lease pass (paper Tables II-III) for G >= 1
// requester groups in one launch.
//
// Replaces src/repro/kernels/tardis_lease/kernel.py: lease_table_many
// (_lease_many_kernel / _lease_many_pred_kernel, via _lease_many_step) and
// lease_table (_lease_kernel / _lease_pred_kernel, the G == 1 case).
//
// Per flat block entry i (one thread each) and group g with mask[g, i]:
//   new_rts[i]  = max over masked g of max(rts, wts + lease, pts_g + lease)
//   flags[g, i] = (req == wts) | (pts_g > rts) << 1   (pre-call snapshot)
// and two reductions that replace the TPU kernel's (R, 1) row maxima:
//   write_ts    = max(max(rts over the union mask), -1) + 1
//   new_pts[g]  = max(pts_g, 0, max(wts over mask & pts_g <= rts))
// Both are int32 max reductions: a warp reduce, then one atomicMax per warp
// on an output the wrapper pre-fills (write_ts = 0, new_pts = max(pts, 0)).
// Integer max is order-independent, so the result is bit-identical however
// the blocks are scheduled.
//
// Bound on the H100: bytes.  Each entry reads wts/rts/req (+ lease) and G
// mask words and writes new_rts and G flag words -- a few bytes of int32
// per entry, no arithmetic to speak of.  At the serving table size (4608
// blocks) the whole pass is ~100 KB, far below what a launch costs, so the
// design keeps it to ONE launch with coalesced int32 accesses; the lease is
// a scalar argument (static policy) or a per-block pointer (predictor).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void lease_pass_kernel(const int* __restrict__ wts,
                                  const int* __restrict__ rts,
                                  const int* __restrict__ req,
                                  const int* __restrict__ masks,
                                  const int* __restrict__ pts,
                                  const int* __restrict__ lease_vec,
                                  int lease, int n, int g,
                                  int* __restrict__ new_rts,
                                  int* __restrict__ flags,
                                  int* __restrict__ write_ts,
                                  int* __restrict__ new_pts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool lane0 = (threadIdx.x & 31) == 0;
  int w = 0, r = 0, rq = 0, L = lease;
  if (in) {
    w = wts[i];
    r = rts[i];
    rq = req[i];
    if (lease_vec != nullptr) L = lease_vec[i];
  }
  int nr = r;
  bool any = false;
  for (int gi = 0; gi < g; ++gi) {
    const int p = pts[gi];
    const size_t at = static_cast<size_t>(gi) * n + i;
    const bool m = in && masks[at] != 0;
    int consumed = 0;
    if (m) {
      const int ext = max(max(r, w + L), p + L);
      nr = max(nr, ext);
      any = true;
      flags[at] = (rq == w ? 1 : 0) | (p > r ? 2 : 0);
      if (p <= r) consumed = w;
    } else if (in) {
      flags[at] = 0;
    }
    consumed = __reduce_max_sync(kFull, consumed);
    if (lane0 && consumed > 0) atomicMax(new_pts + gi, consumed);
  }
  if (in) new_rts[i] = nr;
  int top = any ? r + 1 : 0;
  top = __reduce_max_sync(kFull, top);
  if (lane0 && top > 0) atomicMax(write_ts, top);
}

}  // namespace

extern "C" int tardis_lease_pass(const void* wts, const void* rts,
                                 const void* req, const void* masks,
                                 const void* pts, const void* lease_vec,
                                 int lease, int n, int g, void* new_rts,
                                 void* flags, void* write_ts, void* new_pts,
                                 void* stream) {
  if (n > 0 && g > 0) {
    const int threads = 256;  // a multiple of 32: every warp is full
    const int blocks = (n + threads - 1) / threads;
    lease_pass_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)wts, (const int*)rts, (const int*)req, (const int*)masks,
        (const int*)pts, (const int*)lease_vec, lease, n, g, (int*)new_rts,
        (int*)flags, (int*)write_ts, (int*)new_pts);
  }
  return (int)cudaGetLastError();
}
